// K4: fused affine + LeakyReLU + 2x2x2 stride-2 pooling (max or mean),
// floor semantics: odd tails are dropped.
//
// Replaces three TPU kernels, which are one piece of math in three layouts:
//   transmf_ad_tpu/ops/pool3d.py::_mpa_fwd_kernel (pallas_call at :484),
//     the merged (B, X, Y, Z*C) layout with (Z*C,) lane affine vectors;
//   transmf_ad_tpu/ops/pool3d.py::_bc_fwd_kernel (pallas_call at :762),
//     the conv-native layout with (C,) affine vectors;
//   transmf_ad_tpu/ops/pool3d.py::_pool_fwd_kernel (pallas_call at :136),
//     plain 2x2x2 max or mean, reached here with an identity affine
//     (scale 1, shift 0, slope 1), and the stage-4 end, which on the TPU is
//     bn_affine_reference followed by that kernel's mean mode.
// The TPU kernels reduce y-pairs with 0/1 selection matrices on the MXU and
// z-pairs with lane slices; on the card a thread simply reads its window.
//
// Bound on the card: reading y, which is 8x the output. At the stage-1 end
// (8, 91, 109, 91, 32) bf16 that is 462 MB in, 56 MB out.
//
// Design: one thread per output element, channel-fastest, so a warp reads
// C contiguous channels at each of the 8 window positions and writes C
// contiguous outputs. The affine is read through a z-stride: 0 for (C,)
// vectors and C for (Z*C,) lane vectors. pre = y*s + b is computed with
// explicitly rounded float32 multiply and add (no FMA contraction), so the
// kernel agrees bit for bit with the unfused float32 reference; the
// activation is rounded to the storage type BEFORE the max or the sum, as in
// the TPU kernels. The mean sums the 8 rounded values in float32.
#include "common.cuh"

namespace transmf {
namespace {

constexpr int kThreads = 256;

template <typename T, bool kMean>
__global__ void __launch_bounds__(kThreads)
    affine_act_pool_kernel(const T* __restrict__ y,
                           const float* __restrict__ scale,
                           const float* __restrict__ shift,
                           T* __restrict__ out, int X, int Y, int Z, int C,
                           int Xp, int Yp, int Zp, int zstride, float slope,
                           int64_t total) {
  for (int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       idx < total; idx += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int c = static_cast<int>(idx % C);
    int64_t r = idx / C;
    const int zp = static_cast<int>(r % Zp);
    r /= Zp;
    const int yp = static_cast<int>(r % Yp);
    r /= Yp;
    const int xp = static_cast<int>(r % Xp);
    const int64_t b = r / Xp;

    float best = -INFINITY;
    float sum = 0.f;
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
        const int64_t row =
            ((b * X + 2 * xp + dx) * Y + 2 * yp + dy) * Z + 2 * zp;
#pragma unroll
        for (int dz = 0; dz < 2; ++dz) {
          const float v = to_f32(y[(row + dz) * C + c]);
          const int ai = (2 * zp + dz) * zstride + c;
          const float pre = __fadd_rn(__fmul_rn(v, scale[ai]), shift[ai]);
          const float act = pre >= 0.f ? pre : __fmul_rn(slope, pre);
          const float rounded = to_f32(from_f32<T>(act));
          if (kMean) {
            sum += rounded;
          } else {
            best = fmaxf(best, rounded);
          }
        }
      }
    }
    out[idx] = from_f32<T>(kMean ? sum * 0.125f : best);
  }
}

}  // namespace
}  // namespace transmf

// y: (B, X, Y, Z, C); scale, shift: float32, (C,) when zstride == 0 or (Z*C,)
// when zstride == C; out: (B, X//2, Y//2, Z//2, C). mode 0 = max, 1 = mean.
extern "C" int transmf_affine_act_pool(const void* y, const void* scale,
                                       const void* shift, void* out, int B,
                                       int X, int Y, int Z, int C, int zstride,
                                       float slope, int mode, int dtype,
                                       void* stream) {
  using namespace transmf;
  const int Xp = X / 2, Yp = Y / 2, Zp = Z / 2;
  if (B < 1 || Xp < 1 || Yp < 1 || Zp < 1 || C < 1 || (mode != 0 && mode != 1) ||
      (zstride != 0 && zstride != C)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t total = static_cast<int64_t>(B) * Xp * Yp * Zp * C;
  const int blocks = static_cast<int>(
      ceil_div(total, kThreads) < 132 * 64 ? ceil_div(total, kThreads) : 132 * 64);
  return dispatch(dtype, [&](auto tag) {
    using T = decltype(tag);
    const auto* yy = static_cast<const T*>(y);
    const auto* s = static_cast<const float*>(scale);
    const auto* sh = static_cast<const float*>(shift);
    auto* o = static_cast<T*>(out);
    const auto st = static_cast<cudaStream_t>(stream);
    if (mode == 1) {
      affine_act_pool_kernel<T, true><<<blocks, kThreads, 0, st>>>(
          yy, s, sh, o, X, Y, Z, C, Xp, Yp, Zp, zstride, slope, total);
    } else {
      affine_act_pool_kernel<T, false><<<blocks, kThreads, 0, st>>>(
          yy, s, sh, o, X, Y, Z, C, Xp, Yp, Zp, zstride, slope, total);
    }
  });
}
