// K3: single-input-channel 3x3x3 SAME convolution, the sNet stem (no bias);
// K5: the same convolution with the BatchNorm sums of its output; K6: its
// weight gradient.
//
// K3 replaces transmf_ad_tpu/ops/stem.py::_stem_kernel (pallas_call at
// stem.py:99). With Cin = 1 the contraction is empty for a matrix unit, so
// the TPU kernel folds the z stencil and the 1 -> C channel lift into one
// banded matrix product on the MXU, about 30x redundant FLOPs. That trick is
// specific to the MXU and is not carried over.
//
// Bound on the card: writing the output. At the serving shape
// (8, 91, 109, 91) -> C = 32 the kernel reads 14 MB (bf16) and writes
// 462 MB, against 6.2 GFMA of float32 work.
//
// Design: one block per brick of one x-plane, kTY y-rows and kTZ z-columns.
// The block stages the zero-padded (3, kTY+2, kTZ+2) halo and the 27 x C
// weights in shared memory as float32. Work items run channel-fastest: a warp
// covers consecutive channels of one voxel column, so each store writes C
// contiguous channels of a voxel. An item computes kZT neighbouring z outputs
// from a sliding window of the halo, so each halo value it reads serves up
// to three taps. Every output is one float32 sum of 27 taps, rounded once to
// the storage type.
//
// K5 replaces _stem_stats_kernel (pallas_call at stem.py:195), which adds
// per-lane sums of the float32 accumulator (before rounding) across its
// sequential grid. Here a block walks kXC x-planes of its brick with the K3
// body, and each work item adds its accumulators to its own slot of a
// shared-memory table; the block folds the table to per-channel (sum, sum of
// squares) partials, which reduce_rows adds in a fixed order. The sums are
// per channel, (2, C), not per (z, c) lane as on the TPU: the caller folds the
// lanes to channels at once, and per-lane partials of every block would need
// ~250 MB of scratch at the training shape.
//
// K6 replaces _stem_dw_kernel (pallas_call at stem.py:332):
//   dw[dx, dy, dz, c] = sum over b, x, y, z of
//       xpad[b, x+dx, y+dy, z+dz] * yhat[b, x, y, z, c],
//   yhat = gy + round(a[c] + y * b2[c])   (the BN-statistics cotangents)
// with float32 sums. Bound by reading y and gy (924 MB in bf16 at the stage-1
// training shape). A block stages the input halo of a brick like K3 and walks
// kXC x-planes; thread (position group, channel) forms yhat in registers and
// keeps 27 float32 tap sums for its channel. The block adds its position
// groups in order and writes one (27, C) partial; reduce_rows adds those in a
// fixed order. The TPU kernel's banded MXU form (T = lhs^T @ yhat, then the
// diagonals) is not carried over.
#include "common.cuh"

namespace transmf {
namespace {

constexpr int kTY = 8;
constexpr int kTZ = 32;
constexpr int kZT = 4;  // z outputs per work item
constexpr int kXC = 8;  // x-planes per block in K5 and K6
constexpr int kThreads = 256;
constexpr int kGroups = kTZ / kZT;
constexpr int kItemsPerChannel = kTY * kGroups;
constexpr int kHalo = 3 * (kTY + 2) * (kTZ + 2);

// Stages the zero-padded (3, kTY+2, kTZ+2) input halo of plane xx.
template <typename T>
__device__ __forceinline__ void load_halo(float (*halo)[kTY + 2][kTZ + 2],
                                          const T* __restrict__ x, int64_t b,
                                          int xx, int y0, int z0, int X, int Y,
                                          int Z) {
  for (int i = threadIdx.x; i < kHalo; i += blockDim.x) {
    const int dz = i % (kTZ + 2);
    const int dy = (i / (kTZ + 2)) % (kTY + 2);
    const int dx = i / ((kTZ + 2) * (kTY + 2));
    const int gx = xx + dx - 1, gy = y0 + dy - 1, gz = z0 + dz - 1;
    float val = 0.f;
    if (gx >= 0 && gx < X && gy >= 0 && gy < Y && gz >= 0 && gz < Z) {
      val = to_f32(x[((b * X + gx) * Y + gy) * Z + gz]);
    }
    halo[dx][dy][dz] = val;
  }
}

// K3 (kStats false, one plane per block) and K5 (kStats true, kXC planes per
// block, per-block (2, C) partials of the float32 accumulators).
template <typename T, bool kStats>
__global__ void __launch_bounds__(kThreads)
    stem_conv_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     T* __restrict__ out, float* __restrict__ partial, int X,
                     int Y, int Z, int C, int planes) {
  __shared__ float halo[3][kTY + 2][kTZ + 2];
  // (27, C) weights, tap-major, channel-minor; with kStats then the
  // (2, items) table of each work item's sums over the planes
  extern __shared__ float wsm[];
  const int items = kItemsPerChannel * C;
  float* sums = wsm + 27 * C;

  const int z0 = blockIdx.x * kTZ;
  const int y0 = blockIdx.y * kTY;
  const int nxc = (X + planes - 1) / planes;
  const int64_t b = blockIdx.z / nxc;
  const int x0 = (blockIdx.z % nxc) * planes;
  const int tid = threadIdx.x;

  for (int i = tid; i < 27 * C; i += blockDim.x) wsm[i] = to_f32(w[i]);
  if (kStats) {
    for (int i = tid; i < 2 * items; i += blockDim.x) sums[i] = 0.f;
  }
  for (int xx = x0; xx < min(x0 + planes, X); ++xx) {
    __syncthreads();  // the previous plane's halo is no longer read
    load_halo(halo, x, b, xx, y0, z0, X, Y, Z);
    __syncthreads();
    for (int item = tid; item < items; item += blockDim.x) {
      const int c = item % C;
      const int col = item / C;
      const int lz = (col % kGroups) * kZT;
      const int ly = col / kGroups;
      const int gy = y0 + ly;
      if (gy >= Y || z0 + lz >= Z) continue;

      float acc[kZT];
#pragma unroll
      for (int k = 0; k < kZT; ++k) acc[k] = 0.f;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          float win[kZT + 2];
#pragma unroll
          for (int i = 0; i < kZT + 2; ++i) win[i] = halo[dx][ly + dy][lz + i];
#pragma unroll
          for (int dz = 0; dz < 3; ++dz) {
            const float wv = wsm[((dx * 3 + dy) * 3 + dz) * C + c];
#pragma unroll
            for (int k = 0; k < kZT; ++k) acc[k] = fmaf(win[k + dz], wv, acc[k]);
          }
        }
      }
      T* o = out + (((b * X + xx) * Y + gy) * Z + z0 + lz) * C + c;
      float s = 0.f, ss = 0.f;
#pragma unroll
      for (int k = 0; k < kZT; ++k) {
        if (z0 + lz + k < Z) {
          o[static_cast<int64_t>(k) * C] = from_f32<T>(acc[k]);
          s += acc[k];
          ss = fmaf(acc[k], acc[k], ss);
        }
      }
      if (kStats) {  // the item's slot is its own: no race
        sums[item] += s;
        sums[items + item] += ss;
      }
    }
  }
  if (kStats) {
    __syncthreads();
    const int64_t blk =
        (static_cast<int64_t>(blockIdx.z) * gridDim.y + blockIdx.y) * gridDim.x +
        blockIdx.x;
    const int64_t nblk =
        static_cast<int64_t>(gridDim.x) * gridDim.y * gridDim.z;
    for (int c = tid; c < C; c += blockDim.x) {
      float s = 0.f, ss = 0.f;
      for (int col = 0; col < kItemsPerChannel; ++col) {
        s += sums[col * C + c];
        ss += sums[items + col * C + c];
      }
      partial[blk * C + c] = s;
      partial[(nblk + blk) * C + c] = ss;
    }
  }
}

// K6: per-block (27, C) partials of dw. blockDim = P * C threads, thread
// (pg, c) takes the brick positions pg, pg + P, ...
template <typename T>
__global__ void __launch_bounds__(kThreads)
    stem_dw_kernel(const T* __restrict__ x, const T* __restrict__ y,
                   const T* __restrict__ gy, const float* __restrict__ a,
                   const float* __restrict__ b2, float* __restrict__ partial,
                   int X, int Y, int Z, int C) {
  __shared__ float halo[3][kTY + 2][kTZ + 2];
  extern __shared__ float red[];  // [P][27 * C]
  const int P = blockDim.x / C;
  const int c = threadIdx.x % C;
  const int pg = threadIdx.x / C;
  const int z0 = blockIdx.x * kTZ;
  const int y0 = blockIdx.y * kTY;
  const int nxc = (X + kXC - 1) / kXC;
  const int64_t b = blockIdx.z / nxc;
  const int x0 = (blockIdx.z % nxc) * kXC;
  const float av = a[c], bv = b2[c];

  float acc[27];
#pragma unroll
  for (int t = 0; t < 27; ++t) acc[t] = 0.f;
  for (int xx = x0; xx < min(x0 + kXC, X); ++xx) {
    __syncthreads();
    load_halo(halo, x, b, xx, y0, z0, X, Y, Z);
    __syncthreads();
    for (int pos = pg; pos < kTY * kTZ; pos += P) {
      const int ly = pos / kTZ, lz = pos % kTZ;
      if (y0 + ly >= Y || z0 + lz >= Z) continue;
      const int64_t off = (((b * X + xx) * Y + y0 + ly) * Z + z0 + lz) * C + c;
      // yhat = gy + round(a + y * b2), in the storage type as on the TPU
      const float stat =
          to_f32(from_f32<T>(__fadd_rn(av, __fmul_rn(to_f32(y[off]), bv))));
      const float yh = to_f32(from_f32<T>(to_f32(gy[off]) + stat));
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
          for (int dz = 0; dz < 3; ++dz) {
            acc[(dx * 3 + dy) * 3 + dz] =
                fmaf(halo[dx][ly + dy][lz + dz], yh, acc[(dx * 3 + dy) * 3 + dz]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int t = 0; t < 27; ++t) red[(pg * 27 + t) * C + c] = acc[t];
  __syncthreads();
  const int64_t blk =
      (static_cast<int64_t>(blockIdx.z) * gridDim.y + blockIdx.y) * gridDim.x +
      blockIdx.x;
  for (int i = threadIdx.x; i < 27 * C; i += blockDim.x) {
    float s = 0.f;
    for (int q = 0; q < P; ++q) s += red[q * 27 * C + i];
    partial[blk * 27 * C + i] = s;
  }
}

}  // namespace
}  // namespace transmf

namespace transmf {
namespace {

bool bad_shape(int B, int X, int Y, int Z, int C, int planes) {
  return B < 1 || X < 1 || Y < 1 || Z < 1 || C < 1 || C > 256 ||
         static_cast<int64_t>(B) * ceil_div(X, planes) > 65535;
}

dim3 brick_grid(int B, int X, int Y, int Z, int planes) {
  return dim3(static_cast<unsigned>(ceil_div(Z, kTZ)),
              static_cast<unsigned>(ceil_div(Y, kTY)),
              static_cast<unsigned>(B * ceil_div(X, planes)));
}

}  // namespace
}  // namespace transmf

// x: (B, X, Y, Z); w: (3, 3, 3, C); out: (B, X, Y, Z, C). Needs 1 <= C <= 256
// and B * X <= 65535.
extern "C" int transmf_stem_conv(const void* x, const void* w, void* out,
                                 int B, int X, int Y, int Z, int C, int dtype,
                                 void* stream) {
  using namespace transmf;
  if (bad_shape(B, X, Y, Z, C, 1)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid = brick_grid(B, X, Y, Z, 1);
  const size_t smem = sizeof(float) * 27 * C;
  return dispatch(dtype, [&](auto tag) {
    using T = decltype(tag);
    stem_conv_kernel<T, false><<<grid, kThreads, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<T*>(out), nullptr, X, Y, Z, C, 1);
  });
}

// Blocks of K5 and K6 for a volume, i.e. the rows of their partials.
extern "C" int64_t transmf_stem_blocks(int B, int X, int Y, int Z) {
  using namespace transmf;
  const dim3 g = brick_grid(B, X, Y, Z, kXC);
  return static_cast<int64_t>(g.x) * g.y * g.z;
}

// K5. As transmf_stem_conv, plus stats: float32 (2, C) [sum, sum of squares]
// of the float32 accumulators over B, X, Y, Z. partial: float32 scratch of
// 2 * transmf_stem_blocks(...) * C.
extern "C" int transmf_stem_conv_stats(const void* x, const void* w, void* out,
                                       void* partial, void* stats, int B,
                                       int X, int Y, int Z, int C, int dtype,
                                       void* stream) {
  using namespace transmf;
  if (bad_shape(B, X, Y, Z, C, kXC)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid = brick_grid(B, X, Y, Z, kXC);
  const int64_t nblk = static_cast<int64_t>(grid.x) * grid.y * grid.z;
  const size_t smem = sizeof(float) * (27 + 2 * kItemsPerChannel) * C;
  const auto st = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, [&](auto tag) {
    using T = decltype(tag);
    if (allow_smem(stem_conv_kernel<T, true>, smem) != cudaSuccess) return;
    stem_conv_kernel<T, true><<<grid, kThreads, smem, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<T*>(out), static_cast<float*>(partial), X, Y, Z, C, kXC);
    reduce_rows(static_cast<const float*>(partial), static_cast<float*>(stats),
                nblk, C, 2, st);
  });
}

// K6. x: (B, X, Y, Z); y, gy: (B, X, Y, Z, C) in x's type; a, b2: float32
// (C,); dw: float32 (3, 3, 3, C). partial: float32 scratch of
// 27 * C * transmf_stem_blocks(...).
extern "C" int transmf_stem_dw(const void* x, const void* y, const void* gy,
                               const void* a, const void* b2, void* partial,
                               void* dw, int B, int X, int Y, int Z, int C,
                               int dtype, void* stream) {
  using namespace transmf;
  if (bad_shape(B, X, Y, Z, C, kXC)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid = brick_grid(B, X, Y, Z, kXC);
  const int64_t nblk = static_cast<int64_t>(grid.x) * grid.y * grid.z;
  const int P = kThreads / C;
  const size_t smem = sizeof(float) * static_cast<size_t>(P) * 27 * C;
  const auto st = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, [&](auto tag) {
    using T = decltype(tag);
    if (allow_smem(stem_dw_kernel<T>, smem) != cudaSuccess) return;
    stem_dw_kernel<T><<<grid, P * C, smem, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(y),
        static_cast<const T*>(gy), static_cast<const float*>(a),
        static_cast<const float*>(b2), static_cast<float*>(partial), X, Y, Z, C);
    reduce_rows(static_cast<const float*>(partial), static_cast<float*>(dw),
                nblk, 27 * C, 1, st);
  });
}
