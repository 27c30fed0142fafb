// Shared helpers for the hand-written Hopper kernels of transmf_ad_tpu_torch.
//
// Every kernel is templated on its storage type (float or __nv_bfloat16) and
// accumulates in float. Each extern "C" entry takes raw pointers, sizes, a
// dtype code (0 = float32, 1 = bfloat16) and the CUDA stream, launches on
// that stream, allocates nothing (scratch comes from the wrapper), and
// returns cudaGetLastError() so that the Python wrapper can raise on a
// refused launch.
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

// Raises a kernel's dynamic shared-memory limit above the default 48 KB when
// it needs more (up to the H100's 227 KB); returns the CUDA status.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

namespace {

// Second pass of every cross-block sum: blocks write float32 partials, and
// this kernel adds them up in a fixed order, so that BN statistics and weight
// gradients are the same from run to run (no float atomics).
//   out[s * ncol + j] = sum over r < rows of part[(s * rows + r) * ncol + j]
// for each of `sets` stacked (rows, ncol) matrices. A block owns 32 columns;
// its 32 thread rows each sum a strided subset of the rows in order, then one
// thread per column adds the 32 row sums in order.
constexpr int kRedCols = 32;
constexpr int kRedRows = 32;

__global__ void __launch_bounds__(kRedCols * kRedRows)
    reduce_rows_kernel(const float* __restrict__ part, float* __restrict__ out,
                       int64_t rows, int ncol) {
  __shared__ float red[kRedRows][kRedCols + 1];
  const int col = blockIdx.x * kRedCols + threadIdx.x;
  const float* src = part + static_cast<int64_t>(blockIdx.y) * rows * ncol;
  float s = 0.f;
  if (col < ncol) {
    for (int64_t r = threadIdx.y; r < rows; r += kRedRows) s += src[r * ncol + col];
  }
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && col < ncol) {
    float t = 0.f;
    for (int i = 0; i < kRedRows; ++i) t += red[i][threadIdx.x];
    out[static_cast<int64_t>(blockIdx.y) * ncol + col] = t;
  }
}

inline void reduce_rows(const float* part, float* out, int64_t rows, int ncol,
                        int sets, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(ceil_div(ncol, kRedCols)),
                  static_cast<unsigned>(sets));
  reduce_rows_kernel<<<grid, dim3(kRedCols, kRedRows), 0, stream>>>(part, out,
                                                                    rows, ncol);
}

}  // namespace

}  // namespace transmf
