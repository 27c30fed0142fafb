// Shared helpers for the hand-written Hopper kernels of transmf_ad_tpu_torch.
//
// Every kernel is templated on its storage type (float or __nv_bfloat16) and
// accumulates in float. Each extern "C" entry takes raw pointers, sizes, a
// dtype code (0 = float32, 1 = bfloat16) and the CUDA stream, launches on
// that stream, allocates nothing, and returns cudaGetLastError() so that the
// Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace transmf {

enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Calls f(T{}) with T the storage type named by `dtype`, then reports the
// launch status. An unknown code is refused before anything launches.
template <typename F>
inline int dispatch(int dtype, F f) {
  if (dtype == kFloat32) {
    f(float{});
  } else if (dtype == kBFloat16) {
    f(__nv_bfloat16{});
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

inline int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

}  // namespace transmf
