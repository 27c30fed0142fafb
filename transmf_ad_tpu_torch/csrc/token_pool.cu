// K1: fused dual-modality token pooling, (B, N, D) x 2 -> (B, 4D).
//
// Replaces: transmf_ad_tpu/ops/pooling.py::_pool_kernel (pallas_call at
// pooling.py:37), which holds both token tensors in VMEM and writes the row
// [mean mri, mean pet, max mri, max pet] in one pass.
//
// Bound on the card: launch latency. At the fusion head's shape
// (8, 150, 128) x 2 the kernel reads 0.6 MB (bf16) and writes 8 KB, which is
// well under a microsecond of HBM time.
//
// Design: one thread per (b, d) column. A warp covers 32 neighbouring d of
// one token row, so every load of the token loop is one coalesced segment.
// Sums and maxima are kept in float32 and rounded once to the storage type,
// as the TPU kernel does.
#include "common.cuh"

namespace transmf {
namespace {

template <typename T>
__global__ void token_pool_kernel(const T* __restrict__ mri,
                                  const T* __restrict__ pet,
                                  T* __restrict__ out, int B, int N, int D) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (idx >= static_cast<int64_t>(B) * D) return;
  const int b = static_cast<int>(idx / D);
  const int d = static_cast<int>(idx % D);
  const T* m = mri + static_cast<int64_t>(b) * N * D + d;
  const T* p = pet + static_cast<int64_t>(b) * N * D + d;
  float sum_m = 0.f, sum_p = 0.f;
  float max_m = -INFINITY, max_p = -INFINITY;
  for (int n = 0; n < N; ++n) {
    const float a = to_f32(m[static_cast<int64_t>(n) * D]);
    const float c = to_f32(p[static_cast<int64_t>(n) * D]);
    sum_m += a;
    sum_p += c;
    max_m = fmaxf(max_m, a);
    max_p = fmaxf(max_p, c);
  }
  T* o = out + static_cast<int64_t>(b) * 4 * D + d;
  o[0] = from_f32<T>(sum_m / static_cast<float>(N));
  o[D] = from_f32<T>(sum_p / static_cast<float>(N));
  o[2 * D] = from_f32<T>(max_m);
  o[3 * D] = from_f32<T>(max_p);
}

}  // namespace
}  // namespace transmf

extern "C" int transmf_token_pool(const void* mri, const void* pet, void* out,
                                  int B, int N, int D, int dtype,
                                  void* stream) {
  using namespace transmf;
  constexpr int kThreads = 128;
  const int blocks = static_cast<int>(ceil_div(static_cast<int64_t>(B) * D,
                                               kThreads));
  return dispatch(dtype, [&](auto tag) {
    using T = decltype(tag);
    token_pool_kernel<T><<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(mri), static_cast<const T*>(pet),
        static_cast<T*>(out), B, N, D);
  });
}
