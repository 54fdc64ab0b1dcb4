// Shared helpers of the port's hand-written Hopper kernels.
//
// Every kernel file is compiled on its own into a shared library with a
// plain C interface (nvcc -shared, loaded with ctypes): no PyTorch header
// is included, so each file builds in seconds.  Each exported launcher
// returns the cudaError_t of its launch as an int (0 = success) and the
// Python wrapper raises on anything else.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

namespace repro {

// Masked scores hold exactly this value; the softmax guards test for it.
constexpr float kNegInf = -1e30f;

// dtype codes shared with the Python wrappers (build.DTYPES).
enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Copy `nrows` rows of a row-major (*, D) matrix into shared memory as f32
// with leading dimension `ld`, zero-filling rows [nrows, max_rows).
// Neighbouring threads read neighbouring elements (coalesced).
template <typename T, int D, int NT>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src,
                                          int nrows, int max_rows) {
  for (int e = threadIdx.x; e < max_rows * D; e += NT) {
    const int r = e / D, c = e % D;
    dst[r * ld + c] = r < nrows ? to_f32(src[(size_t)r * D + c]) : 0.f;
  }
}

// The same for rows named by an index list: row r of dst is src row idx[r].
template <typename T, int D, int NT>
__device__ __forceinline__ void gather_rows(float* dst, int ld, const T* src,
                                            const int* idx, int nrows,
                                            int max_rows) {
  for (int e = threadIdx.x; e < max_rows * D; e += NT) {
    const int r = e / D, c = e % D;
    dst[r * ld + c] = r < nrows ? to_f32(src[(size_t)idx[r] * D + c]) : 0.f;
  }
}

// Reductions over the 16 lanes that share one row group (lanes 0-15 or
// 16-31 of a warp).
__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

}  // namespace repro

REPRO_EXPORT const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
