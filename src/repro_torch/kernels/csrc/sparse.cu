// Fine-grained sparse computation, fused and index-driven (paper Alg. 3),
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/sparse.py:104
// sparse_attention_pallas (_sparse_kernel).  For query block i of head h
// (group member g of KV head kvh), one online-softmax sweep from zero
// state runs over the tiles named in tile_idx[b, kvh, i / step, :] (the
// anchor slots first, then the selected stripes), reading K and V rows
// straight from the original (B, Hkv, Nk, D/Dv) tensors.  Key
// row t of slot c enters row r iff
//   valid[b, kvh, g, i / step, c*tile + t] and col <= row < len, col < len
// with col = tile_idx * tile + t and row = q_offset + i*block_q + r.
// Padded rows come out as exact zeros.
//
// Bound on an H100: operations, counting only the kept (row, key) pairs:
// 2 * 2 * D flops per pair against D-wide rows read once.
//
// Design: one block per (64-row slice of the query block, query block,
// b*Hq); the G*block_q rows of a KV group are split across blocks that
// all read the same tables.  The block walks the slots of its superblock
// and gathers the keys its head keeps (valid bit set, at or below the
// block's last row, inside the sequence) into a list in shared memory,
// 64 at a time, with two warp ballots per 64-key chunk.  Each full list
// is one 64-key step of the online softmax: K and V rows are gathered by
// position straight from the original tensors, and the scores and P @ V
// are scalar f32 FMAs from shared memory, as in the flash kernel.  So the
// work follows the kept keys, not the tiles that hold them: the paper's
// stripe granularity, and the time falls with the kept fraction.  An
// unoccupied slot adds no key, so it changes no bit of the result.
#include "attend.cuh"

using namespace repro;

namespace {

template <typename T, int D, int DV>
__global__ void __launch_bounds__(kThreads)
sparse_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ tile_idx,
              const int* __restrict__ tile_valid, const int* __restrict__ valid,
              const int* __restrict__ lengths, const int* __restrict__ q_offset,
              T* __restrict__ out, int Hq, int Hkv, int N, int Nk, int T_s,
              int C_t, int tile, int block_q, int step, float scale) {
  constexpr int LD = D + 1;
  constexpr int LDKV = (D > DV ? D : DV) + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* KVs = Qs + kBQ * LD;
  float* Ps = KVs + kBK * LDKV;
  int* keys = reinterpret_cast<int*>(Ps + kBQ * kLDP);  // 2 * kBK

  const int i = blockIdx.y;
  const int bh = blockIdx.z;
  const int b = bh / Hq, h = bh % Hq;
  const int G = Hq / Hkv, kvh = h / G, g = h % G;
  const int bkv = b * Hkv + kvh;
  const int len = lengths ? min(lengths[b], Nk) : Nk;
  const int off = q_offset ? q_offset[0] : 0;
  const int local0 = blockIdx.x * kBQ;
  const int nrows = min(kBQ, block_q - local0);
  const int qrow0 = i * block_q + local0;  // row of q
  const int grow0 = off + qrow0;            // its global position
  const int glast = grow0 + nrows - 1;
  const int sb = i / step;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int* tidx = tile_idx + ((size_t)bkv * T_s + sb) * C_t;
  const int* tval = tile_valid + ((size_t)bkv * T_s + sb) * C_t;
  const int* vrow = valid + (((size_t)bkv * G + g) * T_s + sb) * (size_t)C_t * tile;
  const T* kp = k + (size_t)bkv * Nk * D;
  const T* vp = v + (size_t)bkv * Nk * DV;

  SoftmaxRows<DV> st;
  st.init();

  // Attend to the first kn gathered keys (kn <= kBK).
  auto attend = [&](int kn) {
    __syncthreads();  // keys[] written; the previous readers are done
    gather_rows<T, D, kThreads>(KVs, LDKV, kp, keys, kn, kBK);
    __syncthreads();
    float s[4][4];
    tile_scores<D>(Qs, KVs, LDKV, ty, tx, s);
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int row = grow0 + ty * 4 + ii;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kk = tx + 16 * j;
        const bool ok = kk < kn && keys[kk] <= row && row < len;
        s[ii][j] = ok ? s[ii][j] * scale : kNegInf;
      }
    }
    st.update(s, Ps, ty, tx);
    __syncthreads();
    gather_rows<T, DV, kThreads>(KVs, LDKV, vp, keys, kn, kBK);
    __syncthreads();
    st.accumulate(Ps, KVs, LDKV, kn, ty, tx);
  };

  if (nrows > 0 && grow0 < len) {
    load_rows<T, D, kThreads>(Qs, LD, q + ((size_t)bh * N + qrow0) * D, nrows,
                              kBQ);
    const int lane = threadIdx.x % 32;
    const unsigned lower = (1u << lane) - 1u;
    int nbuf = 0;  // gathered keys not yet attended (the same in every thread)
    for (int c = 0; c < C_t; ++c) {
      if (!tval[c]) continue;  // an unoccupied slot adds no key
      const int t = tidx[c];
      for (int t0 = 0; t0 < tile; t0 += kBK) {
        const int col0 = t * tile + t0;
        if (col0 > glast || col0 >= len) break;  // masked for every row
        const int kn = min(kBK, tile - t0);
        // Kept keys of this 64-key chunk: valid for this head, at or below
        // the block's last row, inside the sequence.  Every warp computes
        // both ballots, so every thread knows the count without a barrier.
        const int* vb = vrow + (size_t)c * tile + t0;
        const int lim = min(kn, min(glast, len - 1) - col0 + 1);
        const bool b0 = lane < lim && vb[lane] != 0;
        const bool b1 = 32 + lane < lim && vb[32 + lane] != 0;
        const unsigned bal0 = __ballot_sync(0xffffffffu, b0);
        const unsigned bal1 = __ballot_sync(0xffffffffu, b1);
        if (threadIdx.x < 32 && b0)
          keys[nbuf + __popc(bal0 & lower)] = col0 + lane;
        if (threadIdx.x >= 32 && threadIdx.x < 64 && b1)
          keys[nbuf + __popc(bal0) + __popc(bal1 & lower)] = col0 + 32 + lane;
        nbuf += __popc(bal0) + __popc(bal1);
        if (nbuf >= kBK) {
          attend(kBK);
          // Move the overflow (< kBK keys) to the front of the buffer.
          __syncthreads();
          const int rest = nbuf - kBK;
          const int moved = threadIdx.x < rest ? keys[kBK + threadIdx.x] : 0;
          __syncthreads();
          if (threadIdx.x < rest) keys[threadIdx.x] = moved;
          nbuf = rest;
        }
      }
    }
    if (nbuf > 0) attend(nbuf);
  }
  if (nrows > 0) st.store(out + ((size_t)bh * N + qrow0) * DV, nrows, ty, tx);
}

template <typename T, int D, int DV>
int launch(const void* q, const void* k, const void* v, const int* tile_idx,
           const int* tile_valid, const int* valid, const int* lengths,
           const int* q_offset, void* out, int B, int Hq, int Hkv, int N,
           int Nk, int T_s, int C_t, int tile, int block_q, int step,
           float scale, cudaStream_t stream) {
  constexpr int LD = D + 1;
  constexpr int LDKV = (D > DV ? D : DV) + 1;
  const size_t smem =
      sizeof(float) * (kBQ * LD + kBK * LDKV + kBQ * kLDP) +
      sizeof(int) * 2 * kBK;
  auto kern = sparse_kernel<T, D, DV>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((block_q + kBQ - 1) / kBQ, N / block_q, B * Hq);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), tile_idx, tile_valid, valid, lengths, q_offset,
      static_cast<T*>(out), Hq, Hkv, N, Nk, T_s, C_t, tile, block_q, step,
      scale);
  return cudaGetLastError();
}

}  // namespace

// q: (B, Hq, N, D); k: (B, Hkv, Nk, D); v: (B, Hkv, Nk, Dv); one dtype,
// contiguous.  tile_idx, tile_valid: (B, Hkv, T_s, C_t) int32; valid:
// (B, Hkv, G, T_s, C_t*tile) int32; lengths (B,) int32 or null; q_offset
// (1,) int32 or null.  out: (B, Hq, N, Dv).
REPRO_EXPORT int sparse_attention_launch(
    const void* q, const void* k, const void* v, const int* tile_idx,
    const int* tile_valid, const int* valid, const int* lengths,
    const int* q_offset, void* out, int B, int Hq, int Hkv, int N, int Nk,
    int D, int Dv, int dtype, int T_s, int C_t, int tile, int block_q,
    int step, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_SPARSE(T, DIM, DIMV)                                           \
  return launch<T, DIM, DIMV>(q, k, v, tile_idx, tile_valid, valid, lengths, \
                              q_offset, out, B, Hq, Hkv, N, Nk, T_s, C_t,    \
                              tile, block_q, step, scale, s)
  if (dtype == kBF16 && D == 128 && Dv == 128) REPRO_SPARSE(__nv_bfloat16, 128, 128);
  if (dtype == kBF16 && D == 64 && Dv == 64) REPRO_SPARSE(__nv_bfloat16, 64, 64);
  if (dtype == kBF16 && D == 128 && Dv == 64) REPRO_SPARSE(__nv_bfloat16, 128, 64);
  if (dtype == kF32 && D == 128 && Dv == 128) REPRO_SPARSE(float, 128, 128);
  if (dtype == kF32 && D == 64 && Dv == 64) REPRO_SPARSE(float, 64, 64);
  if (dtype == kF32 && D == 128 && Dv == 64) REPRO_SPARSE(float, 128, 64);
#undef REPRO_SPARSE
  return cudaErrorInvalidValue;
}
