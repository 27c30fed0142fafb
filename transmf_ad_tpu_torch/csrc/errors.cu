// Names a status code returned by the kernel entries, for the wrapper's error.
#include "common.cuh"

extern "C" const char* transmf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
