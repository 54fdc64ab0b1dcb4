// Tile arithmetic shared by the flash, anchor and sparse kernels.
//
// A block of kThreads = 256 threads works on a 64-row query tile against
// 64-key sub-tiles, both staged in shared memory as f32.  Thread
// (ty, tx) = (tid / 16, tid % 16) owns query rows ty*4 .. ty*4+3 and, for
// a score tile, key columns tx, tx+16, tx+32, tx+48; for the output it
// owns value columns tx, tx+16, ...  Rows of a row group live in 16
// neighbouring lanes, so row reductions are four shuffles.
//
// Shared-memory rows are padded by one float (ld = D + 1): the 16 lanes
// that read 16 different key rows at the same depth then hit 16 different
// banks.
#pragma once

#include "common.cuh"

namespace repro {

constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 64;       // keys per sub-tile
constexpr int kThreads = 256;
constexpr int kLDP = kBK + 1; // leading dimension of the P tile

// s[i][j] = <Qs[ty*4+i], Ks[tx+16j]> over D (unscaled).
template <int D>
__device__ __forceinline__ void tile_scores(const float* __restrict__ Qs,
                                            const float* __restrict__ Ks,
                                            int ldk, int ty, int tx,
                                            float s[4][4]) {
  constexpr int LDQ = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = Qs[(ty * 4 + i) * LDQ + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Ks[(tx + 16 * j) * ldk + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
}

// Online-softmax state of the four rows a thread owns (replicated over
// the 16 lanes of its row group), with its DV/16 output columns per row.
template <int DV>
struct SoftmaxRows {
  static constexpr int kCols = DV / 16;
  float m[4], l[4], acc[4][kCols];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m[i] = kNegInf;
      l[i] = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
    }
  }

  // `s` holds scaled scores with kNegInf wherever the mask is off.  Writes
  // the tile's probabilities to Ps and rescales the accumulators.  A row
  // whose entries are all masked keeps m = kNegInf, gets p = 0 (the guard
  // below; exp(0) = 1 otherwise) and alpha = 1: an exact no-op.
  __device__ __forceinline__ void update(const float s[4][4], float* Ps,
                                         int ty, int tx) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
      const float m_new = fmaxf(m[i], max16(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = s[i][j] <= kNegInf ? 0.f : expf(s[i][j] - m_new);
        Ps[(ty * 4 + i) * kLDP + tx + 16 * j] = p;
        sum += p;
      }
      sum = sum16(sum);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= alpha;
    }
  }

  // acc += P[:, :kn] @ V[:kn] with V staged in Vs (leading dimension ldv).
  __device__ __forceinline__ void accumulate(const float* __restrict__ Ps,
                                             const float* __restrict__ Vs,
                                             int ldv, int kn, int ty, int tx) {
    for (int kk = 0; kk < kn; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty * 4 + i) * kLDP + kk];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float vv = Vs[kk * ldv + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }

  // out[r] = acc[r] / max(l[r], 1e-30) for the first `nrows` rows; a row
  // with no unmasked key (varlen padding) has acc = l = 0 and writes 0.
  template <typename T>
  __device__ __forceinline__ void store(T* __restrict__ out, int nrows,
                                        int ty, int tx) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      if (r >= nrows) continue;
      const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        out[(size_t)r * DV + tx + 16 * j] = from_f32<T>(acc[i][j] / den);
    }
  }
};

}  // namespace repro
