// K3: single-input-channel 3x3x3 SAME convolution, the sNet stem (no bias).
//
// Replaces: transmf_ad_tpu/ops/stem.py::_stem_kernel (pallas_call at
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
#include "common.cuh"

namespace transmf {
namespace {

constexpr int kTY = 8;
constexpr int kTZ = 32;
constexpr int kZT = 4;  // z outputs per work item
constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    stem_conv_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     T* __restrict__ out, int X, int Y, int Z, int C) {
  __shared__ float halo[3][kTY + 2][kTZ + 2];
  extern __shared__ float wsm[];  // (27, C): tap-major, channel-minor

  const int z0 = blockIdx.x * kTZ;
  const int y0 = blockIdx.y * kTY;
  const int b = blockIdx.z / X;
  const int xx = blockIdx.z % X;
  const int tid = threadIdx.x;

  constexpr int kHalo = 3 * (kTY + 2) * (kTZ + 2);
  for (int i = tid; i < kHalo; i += blockDim.x) {
    const int dz = i % (kTZ + 2);
    const int dy = (i / (kTZ + 2)) % (kTY + 2);
    const int dx = i / ((kTZ + 2) * (kTY + 2));
    const int gx = xx + dx - 1, gy = y0 + dy - 1, gz = z0 + dz - 1;
    float val = 0.f;
    if (gx >= 0 && gx < X && gy >= 0 && gy < Y && gz >= 0 && gz < Z) {
      val = to_f32(x[((static_cast<int64_t>(b) * X + gx) * Y + gy) * Z + gz]);
    }
    halo[dx][dy][dz] = val;
  }
  for (int i = tid; i < 27 * C; i += blockDim.x) wsm[i] = to_f32(w[i]);
  __syncthreads();

  constexpr int kGroups = kTZ / kZT;
  const int items = kTY * kGroups * C;
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
    T* o = out + (((static_cast<int64_t>(b) * X + xx) * Y + gy) * Z + z0 + lz) * C + c;
#pragma unroll
    for (int k = 0; k < kZT; ++k) {
      if (z0 + lz + k < Z) o[static_cast<int64_t>(k) * C] = from_f32<T>(acc[k]);
    }
  }
}

}  // namespace
}  // namespace transmf

// x: (B, X, Y, Z); w: (3, 3, 3, C); out: (B, X, Y, Z, C). Needs 1 <= C <= 256
// and B * X <= 65535.
extern "C" int transmf_stem_conv(const void* x, const void* w, void* out,
                                 int B, int X, int Y, int Z, int C, int dtype,
                                 void* stream) {
  using namespace transmf;
  if (B < 1 || X < 1 || Y < 1 || Z < 1 || C < 1 || C > 256 ||
      static_cast<int64_t>(B) * X > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(ceil_div(Z, kTZ)),
                  static_cast<unsigned>(ceil_div(Y, kTY)),
                  static_cast<unsigned>(B * X));
  const size_t smem = sizeof(float) * 27 * C;
  return dispatch(dtype, [&](auto tag) {
    using T = decltype(tag);
    stem_conv_kernel<T><<<grid, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<T*>(out), X, Y, Z, C);
  });
}
