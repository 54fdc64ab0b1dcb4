// Pattern-based anchor computation, scores only (paper Alg. 1), for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/anchor.py:96
// anchor_phase_pallas (_anchor_kernel).  For query block i of head h:
//   m[r]   = max over the anchor region of q[r].k[c] / sqrt(D), where the
//            region is KV block 0 plus window blocks
//            [max(1, (i/step)*step*r), i*r + r - 1], masked by
//            c <= r < len and c < len;
//   m_bar  = mean of m over the valid rows of the block (+inf if none);
//   q_mean = mean of q over the valid rows (0 if none).
// No V is read and nothing row-resolution is written: the outputs are
// (B, Hq, T_m, D) and (B, Hq, T_m), both f32.
//
// Bound on an H100: operations.  Each query block scores block_q rows
// against up to (1 + step*r) * block_kv keys; at D = 128 that is hundreds
// of flops per byte of q and k read.
//
// Design: one block per (query block, b*Hq).  The block walks its query
// rows in 64-row tiles; for each it loops over 64-key sub-tiles of the
// sink block and the clipped window, stopping at the diagonal and at the
// sequence length (masked keys never change a row maximum).  Row maxima
// are kept in registers, collected in shared memory, and pooled at the
// end; q_mean is pooled straight from device memory with one thread per
// feature.  Scores are f32 scalar FMAs (stripe_select thresholds on the
// result, so it must match the plain version to f32 tolerance).
#include "attend.cuh"

using namespace repro;

namespace {

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
anchor_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const int* __restrict__ lengths, float* __restrict__ q_mean,
              float* __restrict__ m_bar, int Hq, int Hkv, int N, int T_m,
              int t_n, int block_q, int block_kv, int step, int ratio,
              float scale) {
  constexpr int LD = D + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * LD;
  float* rowmax = Ks + kBK * LD;  // block_q floats

  const int i = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh % Hq;
  const int kvbh = b * Hkv + h / (Hq / Hkv);
  const int len = lengths ? min(lengths[b], N) : N;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int w_start = max(1, (i / step) * step * ratio);
  const int last_blk = min(i * ratio + ratio - 1, t_n - 1);
  const int n_blocks = 1 + max(0, last_blk - w_start + 1);
  const int row_base = i * block_q;
  const T* qp = q + ((size_t)bh * N + row_base) * D;
  const T* kp = k + (size_t)kvbh * N * D;

  for (int r0 = 0; r0 < block_q; r0 += kBQ) {
    const int nrows = min(kBQ, block_q - r0);
    const int grow0 = row_base + r0;
    float m[4] = {kNegInf, kNegInf, kNegInf, kNegInf};
    if (grow0 < len) {
      __syncthreads();  // the previous row tile's readers of Qs are done
      load_rows<T, D, kThreads>(Qs, LD, qp + (size_t)r0 * D, nrows, kBQ);
      // Largest key any valid row of this tile may attend to.
      const int key_hi = min(grow0 + nrows - 1, len - 1);
      for (int w = 0; w < n_blocks; ++w) {
        const int blk = w == 0 ? 0 : w_start + w - 1;
        if (blk * block_kv > key_hi) break;  // blocks ascend
        for (int t0 = 0; t0 < block_kv; t0 += kBK) {
          const int col0 = blk * block_kv + t0;
          if (col0 > key_hi) break;
          const int kn = min(kBK, block_kv - t0);
          __syncthreads();
          load_rows<T, D, kThreads>(Ks, LD, kp + (size_t)col0 * D, kn, kBK);
          __syncthreads();
          float s[4][4];
          tile_scores<D>(Qs, Ks, LD, ty, tx, s);
#pragma unroll
          for (int ii = 0; ii < 4; ++ii) {
            const int row = grow0 + ty * 4 + ii;
            float mx = kNegInf;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int kk = tx + 16 * j;
              const int col = col0 + kk;
              const bool ok = kk < kn && col <= row && col < len && row < len;
              mx = fmaxf(mx, ok ? s[ii][j] * scale : kNegInf);
            }
            m[ii] = fmaxf(m[ii], max16(mx));
          }
        }
      }
    }
    if (tx == 0) {
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
        if (ty * 4 + ii < nrows) rowmax[r0 + ty * 4 + ii] = m[ii];
    }
  }
  __syncthreads();

  // Pool over the valid rows only; an all-padding block gives +inf.
  const int cnt = max(0, min(block_q, len - row_base));
  const size_t out_row = (size_t)bh * T_m + i;
  if (threadIdx.x < 32) {
    float sum = 0.f;
    for (int rr = threadIdx.x; rr < cnt; rr += 32) sum += rowmax[rr];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (threadIdx.x == 0)
      m_bar[out_row] = cnt == 0 ? __int_as_float(0x7f800000) : sum / (float)cnt;
  }
  const float denom = (float)max(cnt, 1);
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float sum = 0.f;
    for (int rr = 0; rr < cnt; ++rr) sum += to_f32(qp[(size_t)rr * D + d]);
    q_mean[out_row * D + d] = sum / denom;
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const int* lengths, float* q_mean,
           float* m_bar, int B, int Hq, int Hkv, int N, int block_q,
           int block_kv, int step, float scale, cudaStream_t stream) {
  constexpr int LD = D + 1;
  const size_t smem = sizeof(float) * (kBQ * LD + kBK * LD + block_q);
  auto kern = anchor_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int T_m = N / block_q;
  dim3 grid(T_m, B * Hq);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), lengths, q_mean,
      m_bar, Hq, Hkv, N, T_m, N / block_kv, block_q, block_kv, step,
      block_q / block_kv, scale);
  return cudaGetLastError();
}

}  // namespace

// q: (B, Hq, N, D); k: (B, Hkv, N, D) contiguous, one dtype; lengths (B,)
// int32 or null; q_mean: (B, Hq, N/block_q, D) f32; m_bar: (B, Hq,
// N/block_q) f32.
REPRO_EXPORT int anchor_phase_launch(const void* q, const void* k,
                                     const int* lengths, float* q_mean,
                                     float* m_bar, int B, int Hq, int Hkv,
                                     int N, int D, int dtype, int block_q,
                                     int block_kv, int step, float scale,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_ANCHOR(T, DIM)                                                  \
  return launch<T, DIM>(q, k, lengths, q_mean, m_bar, B, Hq, Hkv, N, block_q, \
                        block_kv, step, scale, s)
  if (dtype == kBF16 && D == 128) REPRO_ANCHOR(__nv_bfloat16, 128);
  if (dtype == kBF16 && D == 64) REPRO_ANCHOR(__nv_bfloat16, 64);
  if (dtype == kF32 && D == 128) REPRO_ANCHOR(float, 128);
  if (dtype == kF32 && D == 64) REPRO_ANCHOR(float, 64);
#undef REPRO_ANCHOR
  return cudaErrorInvalidValue;
}
