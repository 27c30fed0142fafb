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
constexpr int kBwdThreads = 512;

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

// K7, the backward of K4. One block walks whole pooled rows (b, x-pair,
// y-pair) of the extended grid ceil(X/2) x ceil(Y/2): a row inside the pooled
// range recomputes its 2x2x2 windows, a row on an odd x or y tail only writes
// zeros. In a window row, thread t handles the pooled lanes j = t, t + blockDim
// ... (j = zp*C + c), so it always owns the same two raw lanes (2zp, c) and
// (2zp+1, c): it adds dpre*y and dpre into a per-block (2, Z*C) float32 table
// in shared memory without races or atomics. The table goes out as the
// block's partial; reduce_rows adds the partials in a fixed order.
template <typename T, bool kMean, bool kRoundGi>
__global__ void __launch_bounds__(kBwdThreads)
    affine_act_pool_bwd_kernel(const T* __restrict__ y,
                               const float* __restrict__ scale,
                               const float* __restrict__ shift,
                               const T* __restrict__ p, const T* __restrict__ g,
                               T* __restrict__ dy, float* __restrict__ partial,
                               int B, int X, int Y, int Z, int C, int zstride,
                               float slope) {
  extern __shared__ float acc[];  // [2][Z * C]: sum dpre*y, sum dpre
  const int Xp = X / 2, Yp = Y / 2, Zp = Z / 2;
  const int Xq = (X + 1) / 2, Yq = (Y + 1) / 2;
  const int ZC = Z * C;
  const int pooled = Zp * C;
  const T zero = from_f32<T>(0.f);
  for (int i = threadIdx.x; i < 2 * ZC; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();

  const int64_t rows = static_cast<int64_t>(B) * Xq * Yq;
  for (int64_t r = blockIdx.x; r < rows; r += gridDim.x) {
    const int yq = static_cast<int>(r % Yq);
    const int xq = static_cast<int>((r / Yq) % Xq);
    const int64_t b = r / (static_cast<int64_t>(Yq) * Xq);
    if (xq >= Xp || yq >= Yp) {  // odd x or y tail: zero gradient
      for (int dx = 0; dx < 2; ++dx) {
        for (int dyy = 0; dyy < 2; ++dyy) {
          const int gx = 2 * xq + dx, gy = 2 * yq + dyy;
          if (gx >= X || gy >= Y) continue;
          T* o = dy + ((b * X + gx) * Y + gy) * static_cast<int64_t>(ZC);
          for (int i = threadIdx.x; i < ZC; i += blockDim.x) o[i] = zero;
        }
      }
      continue;
    }
    const int64_t prow = ((b * Xp + xq) * Yp + yq) * static_cast<int64_t>(pooled);
    for (int j = threadIdx.x; j < pooled; j += blockDim.x) {
      const int c = j % C;
      const int zp = j / C;
      const float gv = to_f32(g[prow + j]);
      const float pv = kMean ? 0.f : to_f32(p[prow + j]);
      float yv[8], pre[8];
      bool eq[8];
      int cnt = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int dx = k >> 2, dyy = (k >> 1) & 1, dz = k & 1;
        const int64_t off =
            (((b * X + 2 * xq + dx) * Y + 2 * yq + dyy) * Z + 2 * zp + dz) * C + c;
        const int ai = (2 * zp + dz) * zstride + c;
        yv[k] = to_f32(y[off]);
        // the forward's exact arithmetic (K4): rounded product and sum, act
        // rounded to the storage type before the comparison
        pre[k] = __fadd_rn(__fmul_rn(yv[k], scale[ai]), shift[ai]);
        const float act = pre[k] >= 0.f ? pre[k] : __fmul_rn(slope, pre[k]);
        eq[k] = kMean || to_f32(from_f32<T>(act)) == pv;
        cnt += eq[k] ? 1 : 0;
      }
      float gi;
      if (kMean) {
        gi = to_f32(from_f32<T>(gv * 0.125f));
      } else {
        gi = gv / fmaxf(static_cast<float>(cnt), 1.f);
        if (kRoundGi) gi = to_f32(from_f32<T>(gi));
      }
      float ds0 = 0.f, ds1 = 0.f, db0 = 0.f, db1 = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int dx = k >> 2, dyy = (k >> 1) & 1, dz = k & 1;
        const int64_t off =
            (((b * X + 2 * xq + dx) * Y + 2 * yq + dyy) * Z + 2 * zp + dz) * C + c;
        const int ai = (2 * zp + dz) * zstride + c;
        const float dzv = eq[k] ? gi : 0.f;
        const float dpre = pre[k] >= 0.f ? dzv : __fmul_rn(dzv, slope);
        dy[off] = from_f32<T>(__fmul_rn(dpre, scale[ai]));
        if (dz == 0) {
          ds0 = fmaf(dpre, yv[k], ds0);
          db0 += dpre;
        } else {
          ds1 = fmaf(dpre, yv[k], ds1);
          db1 += dpre;
        }
      }
      const int lane = 2 * zp * C + c;
      acc[lane] += ds0;
      acc[lane + C] += ds1;
      acc[ZC + lane] += db0;
      acc[ZC + lane + C] += db1;
    }
    if (Z > 2 * Zp) {  // odd z tail of the four raw rows: zero gradient
      for (int i = threadIdx.x; i < 4 * C; i += blockDim.x) {
        const int k = i / C, c = i % C;
        const int gx = 2 * xq + (k >> 1), gy = 2 * yq + (k & 1);
        dy[(((b * X + gx) * Y + gy) * Z + Z - 1) * C + c] = zero;
      }
    }
  }
  __syncthreads();
  float* part = partial + static_cast<int64_t>(blockIdx.x) * ZC;
  const int64_t set = static_cast<int64_t>(gridDim.x) * ZC;
  for (int i = threadIdx.x; i < ZC; i += blockDim.x) {
    part[i] = acc[i];
    part[set + i] = acc[ZC + i];
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

// y: (B, X, Y, Z, C); scale, shift: as for transmf_affine_act_pool; p, g:
// (B, X//2, Y//2, Z//2, C), the forward's output and its gradient in y's
// type. Writes dy (y's shape, zero on odd tails) and dsb: float32 (2, Z*C)
// [d(scale), d(shift)] per lane when zstride == C, (2, C) per channel when
// zstride == 0. partial: float32 scratch of 2 * grid * Z * C, grid blocks.
// mode 0 = max (ties split equally; round_gi rounds g/count to the storage
// type, as the TPU lane kernel does), 1 = mean.
extern "C" int transmf_affine_act_pool_bwd(
    const void* y, const void* scale, const void* shift, const void* p,
    const void* g, void* dy, void* partial, void* dsb, int B, int X, int Y,
    int Z, int C, int zstride, float slope, int mode, int round_gi, int grid,
    int dtype, void* stream) {
  using namespace transmf;
  if (B < 1 || X < 2 || Y < 2 || Z < 2 || C < 1 || grid < 1 ||
      (mode != 0 && mode != 1) || (zstride != 0 && zstride != C)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(float) * 2 * static_cast<size_t>(Z) * C;
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, [&](auto tag) {
    using T = decltype(tag);
    auto kernel = mode == 1 ? affine_act_pool_bwd_kernel<T, true, false>
                  : round_gi ? affine_act_pool_bwd_kernel<T, false, true>
                             : affine_act_pool_bwd_kernel<T, false, false>;
    if (allow_smem(kernel, smem) != cudaSuccess) return;
    kernel<<<grid, kBwdThreads, smem, st>>>(
        static_cast<const T*>(y), static_cast<const float*>(scale),
        static_cast<const float*>(shift), static_cast<const T*>(p),
        static_cast<const T*>(g), static_cast<T*>(dy),
        static_cast<float*>(partial), B, X, Y, Z, C, zstride, slope);
    // lanes: rows = blocks, columns = Z*C; channels: rows = (block, z)
    if (zstride != 0) {
      reduce_rows(static_cast<const float*>(partial), static_cast<float*>(dsb),
                  grid, Z * C, 2, st);
    } else {
      reduce_rows(static_cast<const float*>(partial), static_cast<float*>(dsb),
                  static_cast<int64_t>(grid) * Z, C, 2, st);
    }
  });
}
