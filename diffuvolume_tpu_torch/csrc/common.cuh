// Shared helpers for the port's kernels: dtype codes, conversions, the
// launch epilogue.  Plain C interface only (no PyTorch headers), so each
// source compiles in seconds; see ops/kernels/_build.py.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#define DV_EXPORT extern "C" __attribute__((visibility("default")))

namespace dv {

// dtype codes, as in ops/kernels/_build.py DTYPE_CODES
enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

inline int ceil_div(long long a, long long b) { return static_cast<int>((a + b - 1) / b); }

// Clear a stale error, select the tensor's device.
inline cudaError_t begin(int device) {
  cudaGetLastError();
  return cudaSetDevice(device);
}

// Status of the launch just made: a refused launch (too many threads, too
// much shared memory) never runs and only shows here.
inline int end() { return static_cast<int>(cudaGetLastError()); }

}  // namespace dv
