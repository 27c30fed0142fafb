// K8: 3x3x3 SAME stride-1 convolution with Cin > 1 on channels-last volumes
// (no bias), optionally with the BatchNorm sums of its output; K9: its weight
// gradient, optionally with the BatchNorm statistics' cotangents folded into
// the output gradient.
//
// K8 replaces transmf_ad_tpu/ops/band_conv.py::_band_kernel and
// _band_stats_kernel (pallas_call at band_conv.py:227). The TPU kernel packs
// the nine (dx, dy) window slices of a z-chunk into one left-hand side and
// multiplies it with a block-band matrix that holds the z stencil, so that the
// MXU sees one large product at the price of (tz + 2) / 3 redundant FLOPs. The
// band, the z-chunks, the lane alignment and the clipped tails exist for the
// MXU and VMEM and are not carried over: this is a direct convolution.
//
// Bound on the card: operations. At (6, 91, 109, 91) with 32 -> 64 channels a
// call is 0.60 TFLOP against 1.0 GB of bf16 traffic; on the CUDA cores that is
// tens of milliseconds of FMAs against a third of a millisecond of HBM time.
//
// K8 design: a block owns one x-plane tile of kFY x kFZ voxels and up to 64
// output channels. It walks the three input planes and, within each, chunks
// of kCK input channels: the zero-padded halo of the chunk goes to shared
// memory as float32, channel-major (one odd-strided plane per channel, so the
// transposing stores do not collide), next to the chunk's (9, kCK, couts)
// weights. A thread owns kFP neighbouring z outputs of one row and 4 (or, with
// J = 2, 2 x 4) output channels in registers: per (dy, ci) it reads a sliding
// window of kFP + 2 inputs, which serves three z taps, and per tap one float4
// of weights, so 13 (16) shared-memory loads feed 96 (192) FMAs. Every output
// is one float32 sum of 27 * Cin products, rounded once to the storage type.
// With statistics, each thread adds its float32 accumulators (before
// rounding) per channel, the block folds its threads in order to one (2, couts)
// partial, and reduce_rows adds the blocks' partials in a fixed order: no
// float atomics, so the sums repeat bit for bit. The sums are per channel,
// (2, Cout), where the TPU kernel returns per-lane (2, Z * Cout) sums that its
// caller folds at once. The input gradient is this kernel on the output
// gradient with the weights reversed in space and Cin / Cout swapped.
//
// K9 replaces _band_dw_kernel and _band_dw_ab_kernel (pallas_calls at
// band_conv.py:378 and :369):
//   dw[dx, dy, dz, ci, co] = sum over b, x, y, z of
//       xpad[b, x+dx, y+dy, z+dz, ci] * yhat[b, x, y, z, co],
//   yhat = gy + round(a[co] + y * b2[co])   (or gy alone)
// with float32 sums. The TPU kernel accumulates T += lhs^T @ yhat per z-chunk
// and reads the taps off the band's diagonals. Here the (27, Cin, Cout) table
// is 110 to 221 KB at the model's widths, too much for one block, so the grid
// splits it by dx, by 32 input channels and by 32 output channels; a block of
// 256 threads then holds a (9, 32, 32) slice in registers, 36 sums a thread
// (one ci, nine (dy, dz) taps, four co). Such a block strides over voxel tiles
// of kWY x kWZ: it stages the input halo of plane x + dx - 1 and the tile's
// yhat (assembled with the TPU kernel's rounding) in shared memory, and every
// thread sweeps the tile's voxels along z with a 3 x 3 sliding window of its
// input channel, 36 FMAs for four shared-memory loads. A block writes its
// slice once, as row g of the partials, and reduce_rows adds the G rows in a
// fixed order. Bound: operations, as K8.
#include "common.cuh"

namespace transmf {
namespace {

constexpr int kThreads = 256;

// K8 tiling
constexpr int kFY = 16;  // tile rows
constexpr int kFZ = 16;  // tile columns
constexpr int kFP = 8;   // z outputs per thread
constexpr int kCK = 16;  // input channels per chunk
constexpr int kHZ = kFZ + 2;
constexpr int kPlane = (kFY + 2) * kHZ + 1;  // odd stride between channels

// K9 tiling
constexpr int kWY = 8;
constexpr int kWZ = 16;
constexpr int kWC = 32;  // channels per block, input and output side
constexpr int kWHZ = kWZ + 2;

template <typename T>
__device__ __forceinline__ void store4(T* p, float a, float b, float c, float d);
template <>
__device__ __forceinline__ void store4<float>(float* p, float a, float b,
                                              float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
template <>
__device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* p, float a,
                                                      float b, float c,
                                                      float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&lo);
  u.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// K8. Grid: (cout block, b, x, y tile, z tile), z tile fastest. J = output
// channels per block / 32. `vec`: Cout % 4 == 0 and `out` 16-byte aligned.
template <typename T, int J, bool kStats>
__global__ void __launch_bounds__(kThreads, 2)
    band_conv_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     T* __restrict__ out, float* __restrict__ partial, int B,
                     int X, int Y, int Z, int Cin, int Cout, int nyt, int nzt,
                     int vec) {
  constexpr int kCB = 32 * J;
  extern __shared__ __align__(16) float smem[];
  float* halo = smem;               // [kCK][kPlane]
  float* wsm = smem + kCK * kPlane;  // [9][kCK][kCB]

  const int tid = threadIdx.x;
  const int cl = tid & 7;  // owns couts cl*4 .. cl*4+3 of each 32
  const int pg = tid >> 3;
  const int ly = pg >> 1;
  const int lz = (pg & 1) * kFP;

  const int64_t spatial = static_cast<int64_t>(B) * X * nyt * nzt;
  const int cb = static_cast<int>(blockIdx.x / spatial);
  const int64_t sblk = blockIdx.x % spatial;
  const int zt = static_cast<int>(sblk % nzt);
  const int yt = static_cast<int>((sblk / nzt) % nyt);
  const int64_t bx = sblk / (static_cast<int64_t>(nzt) * nyt);  // b * X + x
  const int xx = static_cast<int>(bx % X);
  const int64_t b = bx / X;
  const int y0 = yt * kFY, z0 = zt * kFZ, co0 = cb * kCB;

  float acc[J][kFP][4];
#pragma unroll
  for (int j = 0; j < J; ++j) {
#pragma unroll
    for (int p = 0; p < kFP; ++p) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[j][p][q] = 0.f;
    }
  }

  for (int dx = 0; dx < 3; ++dx) {
    const int gx = xx + dx - 1;
    if (gx < 0 || gx >= X) continue;  // the same for the whole block
    for (int c0 = 0; c0 < Cin; c0 += kCK) {
      __syncthreads();  // the previous chunk is no longer read
      for (int i = tid; i < kCK * (kFY + 2) * kHZ; i += kThreads) {
        const int cil = i % kCK;
        const int v = i / kCK;
        const int zz = v % kHZ, yy = v / kHZ;
        const int gy = y0 + yy - 1, gz = z0 + zz - 1, ci = c0 + cil;
        float val = 0.f;
        if (gy >= 0 && gy < Y && gz >= 0 && gz < Z && ci < Cin) {
          val = to_f32(x[(((b * X + gx) * Y + gy) * Z + gz) * Cin + ci]);
        }
        halo[cil * kPlane + yy * kHZ + zz] = val;
      }
      for (int i = tid; i < 9 * kCK * kCB; i += kThreads) {
        const int col = i % kCB;
        const int cil = (i / kCB) % kCK;
        const int tap = i / (kCB * kCK);
        const int ci = c0 + cil, co = co0 + col;
        float val = 0.f;
        if (ci < Cin && co < Cout) {
          val = to_f32(w[(static_cast<int64_t>(dx * 9 + tap) * Cin + ci) * Cout + co]);
        }
        wsm[i] = val;
      }
      __syncthreads();
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll 4
        for (int cil = 0; cil < kCK; ++cil) {
          const float* hp = halo + cil * kPlane + (ly + dy) * kHZ + lz;
          float in[kFP + 2];
#pragma unroll
          for (int k = 0; k < kFP + 2; ++k) in[k] = hp[k];
#pragma unroll
          for (int dz = 0; dz < 3; ++dz) {
#pragma unroll
            for (int j = 0; j < J; ++j) {
              const float4 wv = *reinterpret_cast<const float4*>(
                  wsm + ((dy * 3 + dz) * kCK + cil) * kCB + j * 32 + cl * 4);
#pragma unroll
              for (int p = 0; p < kFP; ++p) {
                acc[j][p][0] = fmaf(in[p + dz], wv.x, acc[j][p][0]);
                acc[j][p][1] = fmaf(in[p + dz], wv.y, acc[j][p][1]);
                acc[j][p][2] = fmaf(in[p + dz], wv.z, acc[j][p][2]);
                acc[j][p][3] = fmaf(in[p + dz], wv.w, acc[j][p][3]);
              }
            }
          }
        }
      }
    }
  }

  const int gy = y0 + ly;
  float s[J][4], ss[J][4];
#pragma unroll
  for (int j = 0; j < J; ++j) {
#pragma unroll
    for (int q = 0; q < 4; ++q) s[j][q] = ss[j][q] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int co = co0 + j * 32 + cl * 4;
#pragma unroll
    for (int p = 0; p < kFP; ++p) {
      const int gz = z0 + lz + p;
      if (gy >= Y || gz >= Z || co >= Cout) continue;
      T* o = out + (((b * X + xx) * Y + gy) * Z + gz) * Cout + co;
      if (vec) {
        store4<T>(o, acc[j][p][0], acc[j][p][1], acc[j][p][2], acc[j][p][3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (co + q < Cout) o[q] = from_f32<T>(acc[j][p][q]);
        }
      }
      if (kStats) {  // couts past Cout have zero weights: their sums are 0
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          s[j][q] += acc[j][p][q];
          ss[j][q] = fmaf(acc[j][p][q], acc[j][p][q], ss[j][q]);
        }
      }
    }
  }
  if (kStats) {
    __syncthreads();    // the halo and the weights are no longer read
    float* red = smem;  // [32 position groups][2][kCB]
#pragma unroll
    for (int j = 0; j < J; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        red[(pg * 2 + 0) * kCB + j * 32 + cl * 4 + q] = s[j][q];
        red[(pg * 2 + 1) * kCB + j * 32 + cl * 4 + q] = ss[j][q];
      }
    }
    __syncthreads();
    for (int i = tid; i < 2 * kCB; i += kThreads) {
      const int set = i / kCB, col = i % kCB;
      float t = 0.f;
      for (int g = 0; g < kThreads / 8; ++g) t += red[(g * 2 + set) * kCB + col];
      if (co0 + col < Cout) {
        partial[(set * spatial + sblk) * Cout + co0 + col] = t;
      }
    }
  }
}

// K9. Grid: G position groups x (cout block, cin block, dx), dx fastest.
// Block g takes the voxel tiles g, g + G, ... and writes row g of `partial`,
// (G, 27, Cin, Cout).
template <typename T, bool kAB>
__global__ void __launch_bounds__(kThreads, 2)
    band_dw_kernel(const T* __restrict__ x, const T* __restrict__ y,
                   const T* __restrict__ gy, const float* __restrict__ a,
                   const float* __restrict__ b2, float* __restrict__ partial,
                   int B, int X, int Y, int Z, int Cin, int Cout, int nyt,
                   int nzt, int ncib, int ncob, int G) {
  __shared__ __align__(16) float xs[(kWY + 2) * kWHZ * kWC];  // [y][z][ci]
  __shared__ __align__(16) float ys[kWY * kWZ * kWC];         // [y][z][co]

  const int tid = threadIdx.x;
  const int cl = tid & 7;    // owns couts cl*4 .. cl*4+3 of the block's 32
  const int cil = tid >> 3;  // owns one of the block's 32 input channels
  const int combos = 3 * ncib * ncob;
  const int combo = blockIdx.x % combos;
  const int g = blockIdx.x / combos;
  const int dx = combo % 3;
  const int ci0 = ((combo / 3) % ncib) * kWC;
  const int co0 = (combo / (3 * ncib)) * kWC;

  // the fill loops below keep a thread on one channel: kThreads % kWC == 0
  const int fc = tid % kWC;
  float av = 0.f, bv = 0.f;
  if (kAB && co0 + fc < Cout) {
    av = a[co0 + fc];
    bv = b2[co0 + fc];
  }

  float acc[3][3][4];
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
    for (int dz = 0; dz < 3; ++dz) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[dy][dz][q] = 0.f;
    }
  }

  const int64_t tiles = static_cast<int64_t>(B) * X * nyt * nzt;
  for (int64_t t = g; t < tiles; t += G) {
    const int zt = static_cast<int>(t % nzt);
    const int yt = static_cast<int>((t / nzt) % nyt);
    const int64_t bx = t / (static_cast<int64_t>(nzt) * nyt);
    const int xx = static_cast<int>(bx % X);
    const int64_t b = bx / X;
    const int gx = xx + dx - 1;
    if (gx < 0 || gx >= X) continue;  // the same for the whole block
    const int y0 = yt * kWY, z0 = zt * kWZ;
    __syncthreads();  // the previous tile is no longer read
    for (int i = tid; i < (kWY + 2) * kWHZ * kWC; i += kThreads) {
      const int v = i / kWC;
      const int zz = v % kWHZ, yy = v / kWHZ;
      const int py = y0 + yy - 1, pz = z0 + zz - 1, ci = ci0 + fc;
      float val = 0.f;
      if (py >= 0 && py < Y && pz >= 0 && pz < Z && ci < Cin) {
        val = to_f32(x[(((b * X + gx) * Y + py) * Z + pz) * Cin + ci]);
      }
      xs[i] = val;
    }
    for (int i = tid; i < kWY * kWZ * kWC; i += kThreads) {
      const int pos = i / kWC;
      const int pz = z0 + pos % kWZ, py = y0 + pos / kWZ, co = co0 + fc;
      float val = 0.f;
      if (py < Y && pz < Z && co < Cout) {
        const int64_t off = (((b * X + xx) * Y + py) * Z + pz) * Cout + co;
        val = to_f32(gy[off]);
        if (kAB) {
          // yhat = gy + round(a + y * b2), in the storage type as on the TPU
          const float stat = to_f32(
              from_f32<T>(__fadd_rn(av, __fmul_rn(to_f32(y[off]), bv))));
          val = to_f32(from_f32<T>(val + stat));
        }
      }
      ys[i] = val;
    }
    __syncthreads();
#pragma unroll 1
    for (int ly = 0; ly < kWY; ++ly) {
      float win[3][3];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        win[dy][1] = xs[((ly + dy) * kWHZ + 0) * kWC + cil];
        win[dy][2] = xs[((ly + dy) * kWHZ + 1) * kWC + cil];
      }
#pragma unroll
      for (int lz = 0; lz < kWZ; ++lz) {
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          win[dy][0] = win[dy][1];
          win[dy][1] = win[dy][2];
          win[dy][2] = xs[((ly + dy) * kWHZ + lz + 2) * kWC + cil];
        }
        const float4 yv = *reinterpret_cast<const float4*>(
            ys + (ly * kWZ + lz) * kWC + cl * 4);
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
          for (int dz = 0; dz < 3; ++dz) {
            acc[dy][dz][0] = fmaf(win[dy][dz], yv.x, acc[dy][dz][0]);
            acc[dy][dz][1] = fmaf(win[dy][dz], yv.y, acc[dy][dz][1]);
            acc[dy][dz][2] = fmaf(win[dy][dz], yv.z, acc[dy][dz][2]);
            acc[dy][dz][3] = fmaf(win[dy][dz], yv.w, acc[dy][dz][3]);
          }
        }
      }
    }
  }

  const int ci = ci0 + cil;
  if (ci < Cin) {
    float* row = partial + static_cast<int64_t>(g) * 27 * Cin * Cout;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dz = 0; dz < 3; ++dz) {
        float* o = row +
                   (static_cast<int64_t>((dx * 3 + dy) * 3 + dz) * Cin + ci) * Cout +
                   co0 + cl * 4;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (co0 + cl * 4 + q < Cout) o[q] = acc[dy][dz][q];
        }
      }
    }
  }
}

bool bad_volume(int B, int X, int Y, int Z, int Cin, int Cout) {
  return B < 1 || X < 1 || Y < 1 || Z < 1 || Cin < 1 || Cout < 1;
}

template <typename T, int J>
void launch_band_conv(const void* x, const void* w, void* out, void* partial,
                      void* stats, int B, int X, int Y, int Z, int Cin,
                      int Cout, int with_stats, cudaStream_t st) {
  const int nyt = static_cast<int>(ceil_div(Y, kFY));
  const int nzt = static_cast<int>(ceil_div(Z, kFZ));
  const int64_t spatial = static_cast<int64_t>(B) * X * nyt * nzt;
  const int64_t blocks = spatial * ceil_div(Cout, 32 * J);
  const size_t smem = sizeof(float) * (kCK * kPlane + 9 * kCK * 32 * J);
  const int vec = Cout % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  auto kernel = with_stats ? band_conv_kernel<T, J, true>
                           : band_conv_kernel<T, J, false>;
  if (allow_smem(kernel, smem) != cudaSuccess) return;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out),
      static_cast<float*>(partial), B, X, Y, Z, Cin, Cout, nyt, nzt, vec);
  if (with_stats) {
    reduce_rows(static_cast<const float*>(partial), static_cast<float*>(stats),
                spatial, Cout, 2, st);
  }
}

}  // namespace
}  // namespace transmf

// Voxel tiles of K8 for a volume, i.e. the rows of its statistics partials.
extern "C" int64_t transmf_band_blocks(int B, int X, int Y, int Z) {
  using namespace transmf;
  return static_cast<int64_t>(B) * X * ceil_div(Y, kFY) * ceil_div(Z, kFZ);
}

// K8. x: (B, X, Y, Z, Cin); w: (3, 3, 3, Cin, Cout) in x's type; out:
// (B, X, Y, Z, Cout). with_stats: also stats, float32 (2, Cout) [sum, sum of
// squares] of the float32 accumulators over B, X, Y, Z, through partial, a
// float32 scratch of 2 * transmf_band_blocks(...) * Cout (both unused
// otherwise).
extern "C" int transmf_band_conv(const void* x, const void* w, void* out,
                                 void* partial, void* stats, int B, int X,
                                 int Y, int Z, int Cin, int Cout,
                                 int with_stats, int dtype, void* stream) {
  using namespace transmf;
  if (bad_volume(B, X, Y, Z, Cin, Cout)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int J = Cout > 32 ? 2 : 1;
  if (transmf_band_blocks(B, X, Y, Z) * ceil_div(Cout, 32 * J) > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, [&](auto tag) {
    using T = decltype(tag);
    if (J == 2) {
      launch_band_conv<T, 2>(x, w, out, partial, stats, B, X, Y, Z, Cin, Cout,
                             with_stats, st);
    } else {
      launch_band_conv<T, 1>(x, w, out, partial, stats, B, X, Y, Z, Cin, Cout,
                             with_stats, st);
    }
  });
}

// K9. x: (B, X, Y, Z, Cin); gy (and y when with_ab): (B, X, Y, Z, Cout) in
// x's type; a, b2: float32 (Cout,), read when with_ab; dw: float32
// (3, 3, 3, Cin, Cout). G >= 1 position groups; partial: float32 scratch of
// G * 27 * Cin * Cout.
extern "C" int transmf_band_dw(const void* x, const void* y, const void* gy,
                               const void* a, const void* b2, void* partial,
                               void* dw, int B, int X, int Y, int Z, int Cin,
                               int Cout, int with_ab, int G, int dtype,
                               void* stream) {
  using namespace transmf;
  if (bad_volume(B, X, Y, Z, Cin, Cout) || G < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nyt = static_cast<int>(ceil_div(Y, kWY));
  const int nzt = static_cast<int>(ceil_div(Z, kWZ));
  const int ncib = static_cast<int>(ceil_div(Cin, kWC));
  const int ncob = static_cast<int>(ceil_div(Cout, kWC));
  const int64_t blocks = static_cast<int64_t>(G) * 3 * ncib * ncob;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, [&](auto tag) {
    using T = decltype(tag);
    auto kernel = with_ab ? band_dw_kernel<T, true> : band_dw_kernel<T, false>;
    kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(y),
        static_cast<const T*>(gy), static_cast<const float*>(a),
        static_cast<const float*>(b2), static_cast<float*>(partial), B, X, Y, Z,
        Cin, Cout, nyt, nzt, ncib, ncob, G);
    reduce_rows(static_cast<const float*>(partial), static_cast<float*>(dw), G,
                27 * Cin * Cout, 1, st);
  });
}
