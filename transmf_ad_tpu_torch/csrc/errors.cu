// Names a status code returned by the kernel entries, for the wrapper's error;
// and an empty kernel, whose time by CUDA events is the launch floor that
// chip_smoke.py prints beside the launch-bound kernels (K1).
#include "common.cuh"

namespace {
__global__ void empty_kernel() {}
}  // namespace

extern "C" const char* transmf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int transmf_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
