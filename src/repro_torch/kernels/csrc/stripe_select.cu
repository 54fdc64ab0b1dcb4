// Difference-aware stripe identification with in-block compaction (paper
// Alg. 2), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/stripe_select.py:107
// stripe_select_pallas (_select_kernel).  For KV head kvh and superblock
// s, a key c of the candidate band [block_kv, w_start(s)) with c < len is
// a hit for query head g of the group iff
//   m_bar[g, p] - q_mean[g, p].k[c] / sqrt(D) <= theta
// for any of the `step` pooled rows p of the superblock (with
// share_kv_groups, the union over the group).  Each query head keeps its
// first `cap_s` hits in ascending position; every tile of `tile` keys
// holding a kept key takes the next slot of the compact tables:
//   tile_idx, tile_valid (B, Hkv, T_s, C_sel), valid (B, Hkv, G, T_s,
//   C_sel*tile), counts (B, Hq, T_s).
// Ascending tile order is part of the contract: the tables must equal the
// plain version's element for element (apart from keys whose margin lies
// within f32 rounding of the threshold).
//
// Bound on an H100: bytes.  The scores are G*step pooled rows against
// each key, a few hundred flops per key of D bf16 values read, and the
// f32/int32 tables written are larger than the keys read.
//
// Design: the TPU kernel carries its slot counter along a sequential grid
// axis.  Blocks on Hopper run in no order, so one block per
// (superblock, b*Hkv) walks the candidate tiles of its band in ascending
// order in a loop.  Thread t owns key column t of the current tile
// (tile <= 128): it scores the column against every pooled row held in
// shared memory and ORs the threshold test over the step rows into a
// per-head bit mask.  Per head, a warp ballot and a block prefix over the
// four warps give each hit its global rank, so the capacity budget needs
// no sort; a block-wide OR decides whether the tile takes a slot.
#include "common.cuh"

using namespace repro;

namespace {

constexpr int kSelThreads = 128;  // one thread per key column of a tile
constexpr int kWarps = kSelThreads / 32;

template <typename T, int D>
__global__ void __launch_bounds__(kSelThreads)
select_kernel(const float* __restrict__ q_mean, const float* __restrict__ m_bar,
              const T* __restrict__ k, const int* __restrict__ lengths,
              int* __restrict__ tile_idx, int* __restrict__ tile_valid,
              int* __restrict__ valid, int* __restrict__ counts, int Hq,
              int Hkv, int T_m, int T_s, int Nk, int step, int block_kv,
              int window_blocks, int tile, int cap_s, int c_sel, float theta,
              float scale, int share) {
  constexpr int LD = D + 1;
  const int G = Hq / Hkv;
  const int R = G * step;  // pooled rows of the group, row r = g*step + p
  extern __shared__ float smem[];
  float* Qm = smem;              // R x D
  float* Mb = Qm + R * D;        // R
  float* Ks = Mb + R;            // tile x LD
  int* warp_hits = reinterpret_cast<int*>(Ks + tile * LD);  // G x kWarps
  int* hits_before = warp_hits + G * kWarps;                // G

  const int s = blockIdx.x;
  const int bkv = blockIdx.y;
  const int b = bkv / Hkv, kvh = bkv % Hkv;
  const int len = lengths ? min(lengths[b], Nk) : Nk;
  const int col = threadIdx.x;
  const int lane = col % 32, warp = col / 32;
  const int w_start = max(1, s * window_blocks) * block_kv;

  // Pooled rows of the group's heads for this superblock; rows past T_m
  // (ragged last superblock) get m_bar = +inf, which never passes.
  for (int e = threadIdx.x; e < R * D; e += kSelThreads) {
    const int r = e / D, d = e % D;
    const int g = r / step, tm = s * step + r % step;
    const int h = kvh * G + g;
    Qm[e] = tm < T_m ? q_mean[(((size_t)b * Hq + h) * T_m + tm) * D + d] : 0.f;
  }
  for (int r = threadIdx.x; r < R; r += kSelThreads) {
    const int g = r / step, tm = s * step + r % step;
    const int h = kvh * G + g;
    Mb[r] = tm < T_m ? m_bar[((size_t)b * Hq + h) * T_m + tm]
                     : __int_as_float(0x7f800000);
  }
  if (threadIdx.x < G) hits_before[threadIdx.x] = 0;

  const size_t tab = ((size_t)bkv * T_s + s) * c_sel;  // tile_idx row
  const size_t vstride = (size_t)T_s * c_sel * tile;   // valid: per head g
  int* vbase = valid + ((size_t)bkv * G * T_s + s) * (size_t)c_sel * tile;
  const T* kp = k + (size_t)bkv * Nk * D;

  const int band_end = min(w_start, len);  // keys at or past it never hit
  const int j_lo = block_kv / tile;
  const int j_hi = (band_end + tile - 1) / tile;
  int slot = 0;
  for (int j = j_lo; j < j_hi; ++j) {
    __syncthreads();  // the previous tile's readers are done
    for (int e = threadIdx.x; e < tile * D; e += kSelThreads) {
      const int r = e / D, d = e % D;
      Ks[r * LD + d] = to_f32(kp[((size_t)j * tile + r) * D + d]);
    }
    __syncthreads();

    const int c = j * tile + col;
    unsigned hitmask = 0;
    if (col < tile && c >= block_kv && c < band_end) {
      for (int r0 = 0; r0 < R; r0 += 8) {
        float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        const int nr = min(8, R - r0);
#pragma unroll 4
        for (int d = 0; d < D; ++d) {
          const float kv = Ks[col * LD + d];
#pragma unroll
          for (int rr = 0; rr < 8; ++rr)
            if (rr < nr) acc[rr] = fmaf(Qm[(r0 + rr) * D + d], kv, acc[rr]);
        }
#pragma unroll
        for (int rr = 0; rr < 8; ++rr)
          if (rr < nr && Mb[r0 + rr] - acc[rr] * scale <= theta)
            hitmask |= 1u << ((r0 + rr) / step);
      }
      if (share && hitmask) hitmask = G == 32 ? ~0u : (1u << G) - 1u;
    }

    // Per-head rank of each hit: hits of earlier tiles + earlier warps of
    // this tile + earlier lanes of this warp.
    for (int g = 0; g < G; ++g) {
      const unsigned bal = __ballot_sync(0xffffffffu, (hitmask >> g) & 1u);
      if (lane == 0) warp_hits[g * kWarps + warp] = __popc(bal);
    }
    __syncthreads();
    unsigned keptmask = 0;
    for (int g = 0; g < G; ++g) {
      const bool hit = (hitmask >> g) & 1u;
      const unsigned bal = __ballot_sync(0xffffffffu, hit);
      if (!hit) continue;
      int rank = hits_before[g] + __popc(bal & ((1u << lane) - 1u));
      for (int w = 0; w < warp; ++w) rank += warp_hits[g * kWarps + w];
      if (rank < cap_s) keptmask |= 1u << g;
    }
    const int any = __syncthreads_or(keptmask != 0);
    if (threadIdx.x < G) {
      int tot = 0;
      for (int w = 0; w < kWarps; ++w) tot += warp_hits[threadIdx.x * kWarps + w];
      hits_before[threadIdx.x] += tot;
    }
    if (any && slot < c_sel) {
      if (col < tile) {
        for (int g = 0; g < G; ++g)
          vbase[g * vstride + (size_t)slot * tile + col] = (keptmask >> g) & 1u;
      }
      if (threadIdx.x == 0) {
        tile_idx[tab + slot] = j;
        tile_valid[tab + slot] = 1;
      }
      ++slot;
    }
  }
  __syncthreads();

  // Unoccupied slots: tile 0, not occupied, no valid rows.
  for (int c = slot + threadIdx.x; c < c_sel; c += kSelThreads) {
    tile_idx[tab + c] = 0;
    tile_valid[tab + c] = 0;
  }
  for (int g = 0; g < G; ++g)
    for (int e = slot * tile + threadIdx.x; e < c_sel * tile; e += kSelThreads)
      vbase[g * vstride + e] = 0;
  if (threadIdx.x < G)
    counts[((size_t)b * Hq + kvh * G + threadIdx.x) * T_s + s] =
        min(hits_before[threadIdx.x], cap_s);
}

template <typename T, int D>
int launch(const float* q_mean, const float* m_bar, const void* k,
           const int* lengths, int* tile_idx, int* tile_valid, int* valid,
           int* counts, int B, int Hq, int Hkv, int T_m, int Nk, int step,
           int block_kv, int window_blocks, int tile, int cap_s, int c_sel,
           float theta, float scale, int share, cudaStream_t stream) {
  constexpr int LD = D + 1;
  const int G = Hq / Hkv, R = G * step;
  const int T_s = (T_m + step - 1) / step;
  const size_t smem = sizeof(float) * ((size_t)R * D + R + (size_t)tile * LD) +
                      sizeof(int) * (G * kWarps + G);
  auto kern = select_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(T_s, B * Hkv);
  kern<<<grid, kSelThreads, smem, stream>>>(
      q_mean, m_bar, static_cast<const T*>(k), lengths, tile_idx, tile_valid,
      valid, counts, Hq, Hkv, T_m, T_s, Nk, step, block_kv, window_blocks,
      tile, cap_s, c_sel, theta, scale, share);
  return cudaGetLastError();
}

}  // namespace

// q_mean: (B, Hq, T_m, D) f32; m_bar: (B, Hq, T_m) f32; k: (B, Hkv, Nk, D);
// lengths (B,) int32 or null.  Outputs (int32): tile_idx, tile_valid
// (B, Hkv, T_s, c_sel); valid (B, Hkv, G, T_s, c_sel*tile); counts
// (B, Hq, T_s).  window_blocks = step * (block_q / block_kv).
REPRO_EXPORT int stripe_select_launch(
    const float* q_mean, const float* m_bar, const void* k, const int* lengths,
    int* tile_idx, int* tile_valid, int* valid, int* counts, int B, int Hq,
    int Hkv, int T_m, int Nk, int D, int dtype, int step, int block_kv,
    int window_blocks, int tile, int cap_s, int c_sel, float theta,
    float scale, int share, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_SELECT(T, DIM)                                                 \
  return launch<T, DIM>(q_mean, m_bar, k, lengths, tile_idx, tile_valid,    \
                        valid, counts, B, Hq, Hkv, T_m, Nk, step, block_kv, \
                        window_blocks, tile, cap_s, c_sel, theta, scale,    \
                        share, s)
  if (dtype == kBF16 && D == 128) REPRO_SELECT(__nv_bfloat16, 128);
  if (dtype == kBF16 && D == 64) REPRO_SELECT(__nv_bfloat16, 64);
  if (dtype == kF32 && D == 128) REPRO_SELECT(float, 128);
  if (dtype == kF32 && D == 64) REPRO_SELECT(float, 64);
#undef REPRO_SELECT
  return cudaErrorInvalidValue;
}
