// Dense causal flash attention with varlen masking, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash.py:83
// flash_attention (_flash_kernel).  Computes, per query head h of batch b,
//   out[r] = softmax_c(q[r].k[c] / sqrt(D), c <= r < len, c < len) @ v
// with K/V read from KV head h / (Hq/Hkv) (no Hq-wide copy), and exact
// zeros for padded rows r >= len.
//
// Bound on an H100: operations.  Causal attention does about
// 2 * 2 * N^2/2 * D flops per head against 4 * N * D bytes of q/k/v/out,
// hundreds of flops per byte, above the card's 295 flop/byte ridge.
//
// Design: one block per (query tile of 64 rows, b*Hq), heaviest tiles
// first.  A loop over 64-key sub-tiles stops at the diagonal and at the
// sequence length, so masked work above either is never loaded.  Q, K, V
// and P are staged in shared memory as f32 and multiplied with scalar f32
// FMAs; the online-softmax state lives in registers.  This first version
// uses no tensor cores (no wgmma, no TMA), so it runs far from the bound:
// its times are recorded in PERF.md and making it fast is later work.
#include "attend.cuh"

using namespace repro;

namespace {

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const int* __restrict__ lengths,
             T* __restrict__ out, int Hq, int Hkv, int N, float scale) {
  constexpr int LD = D + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* KVs = Qs + kBQ * LD;
  float* Ps = KVs + kBK * LD;

  const int qt = gridDim.x - 1 - blockIdx.x;  // long rows first
  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh % Hq;
  const int kvbh = b * Hkv + h / (Hq / Hkv);
  const int len = lengths ? min(lengths[b], N) : N;
  const int row0 = qt * kBQ;
  const int nrows = min(kBQ, N - row0);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const T* kp = k + (size_t)kvbh * N * D;
  const T* vp = v + (size_t)kvbh * N * D;

  SoftmaxRows<D> st;
  st.init();
  if (row0 < len) {
    load_rows<T, D, kThreads>(Qs, LD, q + ((size_t)bh * N + row0) * D,
                              nrows, kBQ);
    const int kv_end = min(row0 + nrows, len);  // keys past it are masked
    for (int c0 = 0; c0 < kv_end; c0 += kBK) {
      const int kn = min(kBK, N - c0);
      __syncthreads();  // the previous sub-tile's readers are done
      load_rows<T, D, kThreads>(KVs, LD, kp + (size_t)c0 * D, kn, kBK);
      __syncthreads();
      float s[4][4];
      tile_scores<D>(Qs, KVs, LD, ty, tx, s);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = row0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = c0 + tx + 16 * j;
          const bool ok = col <= row && col < len && row < len;
          s[i][j] = ok ? s[i][j] * scale : kNegInf;
        }
      }
      st.update(s, Ps, ty, tx);
      __syncthreads();
      load_rows<T, D, kThreads>(KVs, LD, vp + (size_t)c0 * D, kn, kBK);
      __syncthreads();
      st.accumulate(Ps, KVs, LD, kn, ty, tx);
    }
  }
  st.store(out + ((size_t)bh * N + row0) * D, nrows, ty, tx);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           void* out, int B, int Hq, int Hkv, int N, float scale,
           cudaStream_t stream) {
  constexpr int LD = D + 1;
  const size_t smem = sizeof(float) * (kBQ * LD + kBK * LD + kBQ * kLDP);
  auto kern = flash_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + kBQ - 1) / kBQ, B * Hq);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(out), Hq, Hkv, N,
      scale);
  return cudaGetLastError();
}

}  // namespace

// q: (B, Hq, N, D); k, v: (B, Hkv, N, D); out: (B, Hq, N, D), all
// contiguous and of one dtype; lengths: (B,) int32 or null.
REPRO_EXPORT int flash_attention_launch(const void* q, const void* k,
                                        const void* v, const int* lengths,
                                        void* out, int B, int Hq, int Hkv,
                                        int N, int D, int dtype, float scale,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_FLASH(T, DIM) \
  return launch<T, DIM>(q, k, v, lengths, out, B, Hq, Hkv, N, scale, s)
  if (dtype == kBF16 && D == 128) REPRO_FLASH(__nv_bfloat16, 128);
  if (dtype == kBF16 && D == 64) REPRO_FLASH(__nv_bfloat16, 64);
  if (dtype == kF32 && D == 128) REPRO_FLASH(float, 128);
  if (dtype == kF32 && D == 64) REPRO_FLASH(float, 64);
#undef REPRO_FLASH
  return cudaErrorInvalidValue;
}
