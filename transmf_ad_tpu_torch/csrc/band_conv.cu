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
// K8 has two variants, chosen by the caller from the dtype and the channel
// counts alone (ops/band_conv.py::variant) and refused here when they do not
// fit.
//
// K8 "mma" (bfloat16, Cin % 16 == 0, Cin <= 128, Cout % 8 == 0): an implicit
// GEMM on the tensor cores, M = voxels, N = Cout, K = 27 x Cin, bfloat16
// operands and float32 accumulators, rounded once: the same arithmetic as the
// direct kernel, since a bfloat16 product is exact in float32. A block of 8
// warps owns a column of kMY x kMZ = 8 x 16 voxel tiles of one sample (a
// segment of x) and up to 64 output channels, and marches along x:
//   - the zero-padded halo of each input plane tile, (kMY + 2) x (kMZ + 2)
//     voxels, sits in shared memory as bfloat16, channels-last, with the voxel
//     stride padded to Cin + 8 (an odd multiple of 16 bytes). There is no
//     im2col: a tap (dy, dz) is a shifted view of the halo, and ldmatrix takes
//     one row address per lane, so the 16 rows of an A fragment (16 voxels
//     along z) point at (y + dy, z + dz, c0) without bank conflicts;
//   - a ring of four halos: planes x-1, x, x+1 feed the MMAs of output plane
//     x while plane x+2 arrives by cp.async (16 bytes a thread, zero-filled
//     outside the volume), so each input plane tile is read once per column
//     (1.4x with the halo) instead of three times;
//   - epilogue per plane: the four lanes of a quad trade their channel pairs
//     of four 8-channel tiles, so that each stores the 16 bytes of one tile
//     and the quad 64 contiguous bytes of a voxel: whole 32-byte sectors
//     (stores of 8 bytes a lane, half a sector each, cost a fifth of the
//     kernel's time at 64 output channels), masked on the ragged edge. With
//     statistics a thread adds its float32 accumulators (valid voxels only,
//     before rounding) per channel over the whole march, lanes fold by
//     shuffles and warps through shared memory in a fixed order to one
//     (2, couts) partial per block, and reduce_rows adds the blocks: no float
//     atomics, so the sums repeat bit for bit.
// Two kernels carry it. At the models' widths (Cin 32 or 64 with the block's
// (27, Cin, 64 or 32) weights resident beside the ring) band_conv_wgmma_kernel,
// compiled for its Cin: wgmma.m64nNk16 with A from registers and the weights
// as the shared-memory operand, the products of a plane one straight run at
// constant offsets (its own note below). Everywhere else (other Cin; 64 -> 64
// at 221 KB and 128 channels, whose weights are staged 9, 3 or 1 taps at a
// time, again per output plane) band_conv_mma_kernel on mma.sync.m16n8k16: a
// warp owns 16 (or, at 64 output channels, 2 x 16) voxels x 32 output
// channels and per (tap, 16 input channels) runs one ldmatrix for A per 16
// voxels and two ldmatrix.trans for B, from weights whose 16-byte pieces are
// XOR-swizzled by their row. With Cin and the staging known only at run time,
// the index arithmetic of each tap and every warp's own loads of the same
// weights set that kernel's time, not the tensor cores (ablate_band_conv.py,
// PERF.md): it is the general case, not the fast one.
// Bound: operations; what the design leaves on the table is named in PERF.md.
//
// K8 "direct" (float32, where the card-vs-CPU checks hold it to 1e-4, which
// neither bfloat16 nor TF32 products give; and bfloat16 with other channel
// counts): a block owns one x-plane tile of kFY x kFZ voxels and up to 64
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
// and reads the taps off the band's diagonals. Here the contraction runs over
// the voxels (K = B X Y Z, 5.4 million at full resolution) and is split over
// blocks: each block sums its share of the voxel tiles into a slice of one
// row of float32 partials, and reduce_rows adds the rows in a fixed order
// (no float atomics: the result repeats bit for bit). The (27, Cin, Cout)
// table is 110 to 221 KB of float32 at the model's widths, more than a
// block's registers, so the grid splits it by blocks of channels (and, in
// the direct kernel, by dx).
// Bound: operations (0.6 TFLOP at 32 -> 64), as K8.
//
// Two variants, chosen by the caller from the dtype and the channel counts
// alone (ops/band_conv.py::dw_variant) and refused here when they do not fit:
//
// K9 "mma" (bfloat16, Cin % 16 == 0, Cout % 8 == 0): an implicit GEMM on
// mma.sync.m16n8k16, M = taps x Cin, N = Cout, K = voxels. The orientation:
// both operands are voxel-major (channels-last), so one ldmatrix.trans per
// operand turns 16 voxels of 8-channel rows into an A fragment (16 input
// channels x 16 voxels) or a pair of B fragments (16 voxels x 16 output
// channels); M = taps x Cin keeps Cin % 16 and Cout % 8 the only conditions
// (the m16 and n8 of the product) and lets all 27 taps share one yhat
// fragment. K8's march, with the roles of weights and output swapped: a
// block owns a column of 16 x 16 voxel tiles of one sample (a segment of x),
// 32 input channels (16 where Cin is an odd multiple of 16) and 32 output
// channels, in two groups of 9 warps of 16 channels each (one group where
// Cout <= 16); warp (dx, dz) of a group owns the three taps (dx, 0..2, dz)
// of its slice, 48 float32 sums a thread at most. Per plane:
//   - a ring of four input halos, (kDY + 2) x (kDZ + 2) voxels of the
//     block's input channels: planes x - 1, x, x + 1 feed the products of
//     output plane x while plane x + 2 and the gy (and y) tile of plane
//     x + 1 arrive by cp.async (16 bytes a thread, zeros outside the volume
//     and past Cout), so every input is read once per column (1.27x with
//     the halo) and gy, y once;
//   - with a, b2 the block assembles yhat in place with the direct kernel's
//     rounding (__fmul_rn / __fadd_rn, round to bfloat16, add, round), zero
//     outside the volume, where round(a) is not;
//   - a warp walks the 18 rows of its plane's halo: per 16 input channels
//     one A fragment of row r (16 voxels from column dz: a tap is a view of
//     the halo, no im2col) serves its three taps, with the B fragments of
//     yhat rows r, r - 1 and r - 2, which stay in registers as a window.
//     Voxel strides of Cin + 8 and Cout + 8 elements (odd multiples of 16
//     bytes) keep the eight rows of every ldmatrix on distinct banks.
// bfloat16 products are exact in float32, so only the order of the float32
// sums differs from the direct kernel. A block writes its slice of row
// `column` of the partials once, at the end of its march. What bounds it
// (latency: no part removed alone takes more than a quarter of its time) is
// in PERF.md, from ablate_band_conv.py.
//
// K9 "direct" (float32, and bfloat16 with other channel counts): the grid
// splits the table by dx, by 32 input channels and by 32 output channels; a
// block of 256 threads holds a (9, 32, 32) slice in registers, 36 sums a
// thread (one ci, nine (dy, dz) taps, four co). Such a block strides over
// voxel tiles of kWY x kWZ: it stages the input halo of plane x + dx - 1 and
// the tile's yhat (assembled with the TPU kernel's rounding) in shared memory
// as float32, and every thread sweeps the tile's voxels along z with a 3 x 3
// sliding window of its input channel, 36 FMAs for four shared-memory loads.
// A block writes its slice once, as row g of the partials.
#include <initializer_list>
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

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

// K8 "mma" tiling
constexpr int kMY = 8;    // tile rows, one 16-voxel MMA row tile each
constexpr int kMZ = 16;   // tile columns
constexpr int kMHZ = kMZ + 2;
constexpr int kMHalo = (kMY + 2) * kMHZ;  // voxels of a plane tile's halo
constexpr int kRing = 4;                  // halos in flight
constexpr int kMaxSmem = 232448;          // bytes a block may use (227 KB)
constexpr unsigned kFull = 0xffffffffu;
constexpr int kGroup = 4;                 // products per wgmma group

// Elements of the wgmma kernel's weights in shared memory: whole blocks of 64
// k for each of the block's output channels.
__host__ __device__ constexpr int wgmma_weight_elems(int cin, int cout_block) {
  return (27 * cin + 63) / 64 * 64 * cout_block;
}

// K9 tiling
constexpr int kWY = 8;
constexpr int kWZ = 16;
constexpr int kWC = 32;  // channels per block, input and output side
constexpr int kWHZ = kWZ + 2;

// K9 "mma" tiling: a tile of kDY rows of kDZ voxels (one MMA's depth each)
constexpr int kDY = 16;
constexpr int kDZ = 16;
constexpr int kDHZ = kDZ + 2;
constexpr int kDHalo = (kDY + 2) * kDHZ;  // voxels of a tile's input halo
constexpr int kDTaps = 9;  // warps per group of output channels: (dx, dz)
constexpr int kDwBlocks = 6 * 132;  // K9 "direct" blocks in all

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

// What the two K8 "mma" kernels share: where a block works, how a plane's
// halo arrives, and how the statistics fold.

// Grid: (cout block, b, x segment, y tile, z tile), z tile fastest.
struct MmaBlock {
  int64_t spatial;  // blocks per block of output channels: rows of `partial`
  int64_t sblk, b;  // this block's row of them, its sample
  int y0, z0, co0;  // first voxel row, column and output channel
  int xs, xe;       // its planes
};

__device__ __forceinline__ MmaBlock mma_block(int B, int X, int nyt, int nzt,
                                              int segs, int seg_len,
                                              int cout_block) {
  MmaBlock k;
  k.spatial = static_cast<int64_t>(B) * segs * nyt * nzt;
  k.sblk = blockIdx.x % k.spatial;
  k.co0 = static_cast<int>(blockIdx.x / k.spatial) * cout_block;
  k.z0 = static_cast<int>(k.sblk % nzt) * kMZ;
  k.y0 = static_cast<int>((k.sblk / nzt) % nyt) * kMY;
  const int64_t tiles = static_cast<int64_t>(nzt) * nyt;
  k.xs = static_cast<int>((k.sblk / tiles) % segs) * seg_len;
  k.xe = min(X, k.xs + seg_len);
  k.b = k.sblk / (tiles * segs);
  return k;
}

// The zero-padded halo of plane p (-1 .. X) of the block's tile goes to slot
// (p + 1) % kRing of `halo` by cp.async, zeros outside the volume. CS: voxel
// stride of a halo.
__device__ __forceinline__ void load_plane(__nv_bfloat16* halo,
                                           const __nv_bfloat16* x,
                                           const MmaBlock& k, int p, int X,
                                           int Y, int Z, int Cin, int CS) {
  __nv_bfloat16* dst = halo + ((p + 1) & (kRing - 1)) * kMHalo * CS;
  const bool inside = p >= 0 && p < X;
  const int cpv = Cin / 8;  // 16-byte pieces per voxel
  for (int i = threadIdx.x; i < kMHalo * cpv; i += kThreads) {
    const int vox = i / cpv, c = i % cpv;
    const int gy = k.y0 + vox / kMHZ - 1, gz = k.z0 + vox % kMHZ - 1;
    const bool real = inside && gy >= 0 && gy < Y && gz >= 0 && gz < Z;
    const __nv_bfloat16* src =
        real ? x + (((k.b * X + p) * Y + gy) * Z + gz) * Cin + c * 8 : x;
    cp_async16(dst + vox * CS + c * 8, src, real);
  }
}

// One C fragment (voxels g and g + 8 of a row, the lane's 2 channels) into
// the lane's sums; ok0, ok1: the two voxels lie inside the volume.
__device__ __forceinline__ void add_stats(float (&s)[2], float (&ss)[2],
                                          const float* c, bool ok0, bool ok1) {
  if (ok0) {
    s[0] += c[0];
    s[1] += c[1];
    ss[0] = fmaf(c[0], c[0], ss[0]);
    ss[1] = fmaf(c[1], c[1], ss[1]);
  }
  if (ok1) {
    s[0] += c[2];
    s[1] += c[3];
    ss[0] = fmaf(c[2], c[2], ss[0]);
    ss[1] = fmaf(c[3], c[3], ss[1]);
  }
}

// The block's sums: lanes fold their N tiles (the first is tile `tile0` of
// the block) over the quads by shuffles, warps through `red`, [rows][2][kCB]
// floats of shared memory that nothing else uses any more, in a fixed order,
// into the block's row of `partial`. `row`: this warp's among `rows`. Sums of
// couts past Cout are 0 (zero weights) and are not written.
template <int N>
__device__ __forceinline__ void fold_stats(float* red, const float (&s)[N][2],
                                           const float (&ss)[N][2], int row,
                                           int rows, int tile0, int kCB,
                                           float* partial, const MmaBlock& k,
                                           int Cout) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int nj = 0; nj < N; ++nj) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float a = s[nj][e], q = ss[nj][e];
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        a += __shfl_xor_sync(kFull, a, o);
        q += __shfl_xor_sync(kFull, q, o);
      }
      if (lane < 4) {
        const int col = (tile0 + nj) * 8 + 2 * lane + e;
        red[(row * 2 + 0) * kCB + col] = a;
        red[(row * 2 + 1) * kCB + col] = q;
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * kCB; i += kThreads) {
    const int set = i / kCB, col = i % kCB;
    float sum = 0.f;
    for (int r = 0; r < rows; ++r) sum += red[(r * 2 + set) * kCB + col];
    if (k.co0 + col < Cout) {
      partial[(set * k.spatial + k.sblk) * Cout + k.co0 + col] = sum;
    }
  }
}

// K8 "mma", the general kernel on mma.sync. NT: 8-channel output tiles per
// block (4 or 8). `taps`: weights staged at a time (27: once per block).
template <int NT, bool kStats>
__global__ void __launch_bounds__(kThreads, 1)
    band_conv_mma_kernel(const __nv_bfloat16* __restrict__ x,
                         const __nv_bfloat16* __restrict__ w,
                         __nv_bfloat16* __restrict__ out,
                         float* __restrict__ partial, int B, int X, int Y,
                         int Z, int Cin, int Cout, int nyt, int nzt, int segs,
                         int seg_len, int taps) {
  constexpr int kCB = 8 * NT;          // output channels per block
  constexpr int kWarpsN = NT / 4;      // a warp owns 4 of the NT tiles
  constexpr int kWarpsM = 8 / kWarpsN;
  constexpr int kWM = kMY / kWarpsM;   // 16-voxel row tiles per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int CS = Cin + 8;  // voxel stride of a halo
  __nv_bfloat16* halo = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* wsm = halo + kRing * kMHalo * CS;  // [taps][Cin][kCB]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;

  const MmaBlock k = mma_block(B, X, nyt, nzt, segs, seg_len, kCB);
  const int y0 = k.y0, z0 = k.z0, co0 = k.co0;

  // the piece (row, c) of a stage's [rows][NT] weights sits at piece
  // c ^ swizzle(row): eight rows of one ldmatrix then hit eight bank groups
  auto load_weights = [&](int tap0, int count) {
    for (int i = tid; i < count * Cin * NT; i += kThreads) {
      const int row = i / NT, c = i % NT;
      const int co = co0 + c * 8;
      const bool real = co < Cout;
      const __nv_bfloat16* src =
          real ? w + (static_cast<int64_t>(tap0) * Cin + row) * Cout + co : w;
      const int sw = NT == 8 ? (row & 7) : ((row >> 1) & 3);
      cp_async16(wsm + (row * NT + (c ^ sw)) * 8, src, real);
    }
  };

  const bool staged = taps < 27;
  if (!staged) load_weights(0, 27);
  for (int p = k.xs - 1; p <= k.xs + 1; ++p) {
    load_plane(halo, x, k, p, X, Y, Z, Cin, CS);
    cp_async_commit();
  }

  // lane offsets of the ldmatrix rows: A (voxel lane % 16 of the row tile, 8
  // channels further for the upper lanes), B (input channel row, swizzled
  // piece of each of the warp's two pairs of output tiles)
  int a_lane[kWM];
#pragma unroll
  for (int mi = 0; mi < kWM; ++mi) {
    a_lane[mi] = ((wm * kWM + mi) * kMHZ + (lane & 15)) * CS + (lane >> 4) * 8;
  }
  const int b_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int b_sw = NT == 8 ? (lane & 7) : ((lane >> 1) & 3);
  int b_lane[2];
#pragma unroll
  for (int np = 0; np < 2; ++np) {
    b_lane[np] = (b_row * NT + ((wn * 4 + np * 2 + (lane >> 4)) ^ b_sw)) * 8;
  }

  float s[4][2], ss[4][2];
#pragma unroll
  for (int nj = 0; nj < 4; ++nj) {
    s[nj][0] = s[nj][1] = ss[nj][0] = ss[nj][1] = 0.f;
  }

  for (int xx = k.xs; xx < k.xe; ++xx) {
    load_plane(halo, x, k, xx + 2, X, Y, Z, Cin, CS);
    cp_async_commit();
    cp_async_wait<1>();  // planes up to xx + 1 (and the weights) have landed
    __syncthreads();

    float acc[kWM][4][4];
#pragma unroll
    for (int mi = 0; mi < kWM; ++mi) {
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;
      }
    }
    // acc += the (16 voxels x 16 channels) fragments at `ap` times the
    // (16 channels x kCB) weights at `bp`
    auto product = [&](const __nv_bfloat16* ap, const __nv_bfloat16* bp) {
      unsigned a[kWM][4];
#pragma unroll
      for (int mi = 0; mi < kWM; ++mi) ldmatrix_x4(a[mi], ap + a_lane[mi]);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        unsigned bf[4];
        ldmatrix_x4_trans(bf, bp + b_lane[np]);
#pragma unroll
        for (int mi = 0; mi < kWM; ++mi) {
          mma_bf16(acc[mi][2 * np], a[mi], bf[0], bf[1]);
          mma_bf16(acc[mi][2 * np + 1], a[mi], bf[2], bf[3]);
        }
      }
    };
    for (int tap0 = 0; tap0 < 27; tap0 += taps) {
      if (staged) {
        __syncthreads();  // the previous stage's weights are no longer read
        load_weights(tap0, taps);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
      }
      for (int tl = 0; tl < taps; ++tl) {
        const int tap = tap0 + tl;
        const int dx = tap / 9, dy = (tap / 3) % 3, dz = tap % 3;
        const __nv_bfloat16* ap = halo +
                                  ((xx + dx) & (kRing - 1)) * kMHalo * CS +
                                  (dy * kMHZ + dz) * CS;
        const __nv_bfloat16* bp = wsm + tl * Cin * kCB;
#pragma unroll 2
        for (int c0 = 0; c0 < Cin; c0 += 16) product(ap + c0, bp + c0 * kCB);
      }
    }

    // the quad's lanes trade their channel pairs of the warp's four tiles, so
    // that lane t stores the 8 channels of tile t: 64 contiguous bytes of
    // voxel g, then of voxel g + 8, a quad
#pragma unroll
    for (int mi = 0; mi < kWM; ++mi) {
      const int gy = y0 + wm * kWM + mi;
      const bool row_ok = gy < Y;
      const int64_t voxel = ((k.b * X + xx) * Y + gy) * Z;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gz = z0 + g + 8 * h;
        unsigned v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          v[j] = pack_bf16(acc[mi][j][2 * h], acc[mi][j][2 * h + 1]);
        }
        const uint4 tile = quad_transpose(v, t);
        const int co = co0 + (wn * 4 + t) * 8;
        if (row_ok && gz < Z && co < Cout) {
          *reinterpret_cast<uint4*>(out + (voxel + gz) * Cout + co) = tile;
        }
      }
      if (kStats && row_ok) {
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) {
          add_stats(s[nj], ss[nj], acc[mi][nj], z0 + g < Z, z0 + g + 8 < Z);
        }
      }
    }
    __syncthreads();  // plane xx - 1's slot is free for plane xx + 3
  }

  cp_async_wait<0>();  // the planes fetched past the segment's end
  if (kStats) {
    __syncthreads();  // nothing reads or writes the halos any more
    fold_stats<4>(reinterpret_cast<float*>(smem_raw), s, ss, wm, kWarpsM,
                  wn * 4, kCB, partial, k, Cout);
  }
}

// K8 "mma" at the models' widths: the same march on wgmma. CIN (32 or 64) and
// NT are known when the kernel is compiled and the weights are resident. A
// block is two warpgroups; a warpgroup owns four rows of the
// 8 x 16 voxel tile (64 voxels, 16 a warp) and all kCB output channels, one
// m64nNk16 product per (tap, 16 input channels):
//   - A comes from registers: each warp's ldmatrix of its 16 voxels, as in
//     the mma.sync kernel;
//   - B is read by the tensor cores straight from shared memory, once per
//     warpgroup and not once per warp (with mma.sync the eight warps' own
//     ldmatrix of the same weights are two thirds of the shared-memory
//     traffic, which bounds that kernel): k-major (k = tap * CIN + ci)
//     blocks of 64 k under the 128-byte swizzle, on a 1,024-byte boundary,
//     transposed into shared memory once per block;
//   - the 27 * CIN / 16 products of a plane unroll into one straight run at
//     constant offsets; they go to the tensor cores in groups of kGroup, and
//     while one group runs the fragments of the next load into the other set
//     of registers.
// Grid, ring, epilogue and statistics as in the mma.sync kernel.
template <int NT, bool kStats, int CIN>
__global__ void __launch_bounds__(kThreads, 1)
    band_conv_wgmma_kernel(const __nv_bfloat16* __restrict__ x,
                           const __nv_bfloat16* __restrict__ w,
                           __nv_bfloat16* __restrict__ out,
                           float* __restrict__ partial, int B, int X, int Y,
                           int Z, int Cout, int nyt, int nzt, int segs,
                           int seg_len) {
  constexpr int kCB = 8 * NT;          // output channels per block
  constexpr int CS = CIN + 8;          // voxel stride of a halo
  constexpr int kPerTap = CIN / 16;    // products per tap
  constexpr int kSteps = 27 * kPerTap;  // products per plane
  constexpr int kGroups = (kSteps + kGroup - 1) / kGroup;
  extern __shared__ __align__(1024) unsigned char smem_wg[];
  // [64-k blocks][kCB][64] weights, then the ring of halos
  __nv_bfloat16* wsm = reinterpret_cast<__nv_bfloat16*>(smem_wg);
  __nv_bfloat16* halo = wsm + wgmma_weight_elems(CIN, kCB);

  if (smem_address(smem_wg) % 1024 != 0) __trap();  // the swizzle's boundary

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;  // warp: the tile row it owns
  const int g = lane / 4, t = lane % 4;

  const MmaBlock k = mma_block(B, X, nyt, nzt, segs, seg_len, kCB);
  const int y0 = k.y0, z0 = k.z0, co0 = k.co0;

  // the weights turn k-major on their way in: the 8 output channels at
  // (kk, n0 .. n0 + 7), 16 contiguous bytes of w, go to column kk of rows n0
  // .. n0 + 7 of the 64-k blocks, the 16-byte piece c of row n at piece
  // c ^ (n % 8). Neighbouring lanes take neighbouring kk: their stores fall
  // into different banks.
  constexpr int kK = 27 * CIN;
  for (int i = tid; i < kK * NT; i += kThreads) {
    const int kk = i % kK, n0 = (i / kK) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (co0 + n0 < Cout) {
      v = *reinterpret_cast<const uint4*>(
          w + static_cast<int64_t>(kk) * Cout + co0 + n0);
    }
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + j;
      wsm[((kk / 64) * kCB + n) * 64 + (((kk % 64) / 8) ^ (n & 7)) * 8 +
          kk % 8] = e[j];
    }
  }
  for (int p = k.xs - 1; p <= k.xs + 1; ++p) {
    load_plane(halo, x, k, p, X, Y, Z, CIN, CS);
    cp_async_commit();
  }

  // ldmatrix row of this lane in an A fragment: voxel lane % 16 of the warp's
  // tile row, 8 channels further for the upper lanes
  const int a_lane = (warp * kMHZ + (lane & 15)) * CS + (lane >> 4) * 8;
  const uint64_t b_desc = wgmma_desc_k128(wsm);

  float s[NT][2], ss[NT][2];
#pragma unroll
  for (int nj = 0; nj < NT; ++nj) {
    s[nj][0] = s[nj][1] = ss[nj][0] = ss[nj][1] = 0.f;
  }

  for (int xx = k.xs; xx < k.xe; ++xx) {
    load_plane(halo, x, k, xx + 2, X, Y, Z, CIN, CS);
    cp_async_commit();
    cp_async_wait<1>();  // planes up to xx + 1 (and the weights) have landed
    fence_async_proxy();  // the tensor cores read what cp.async wrote
    __syncthreads();

    float acc[4 * NT];
#pragma unroll
    for (int i = 0; i < 4 * NT; ++i) acc[i] = 0.f;
    const __nv_bfloat16* plane[3];
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      plane[dx] = halo + ((xx + dx) & (kRing - 1)) * kMHalo * CS + a_lane;
    }
    // group i of the plane's products: its A fragments, then its MMAs
    auto fetch = [&](unsigned (&ag)[kGroup][4], int i) {
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const int step = i * kGroup + j;
        if (step < kSteps) {
          const int tap = step / kPerTap, kc = step % kPerTap;
          const int dx = tap / 9, dy = (tap / 3) % 3, dz = tap % 3;
          ldmatrix_x4(ag[j], plane[dx] + (dy * kMHZ + dz) * CS + kc * 16);
        }
      }
    };
    auto multiply = [&](unsigned (&ag)[kGroup][4], int i) {
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const int step = i * kGroup + j;
        if (step < kSteps) {
          wgmma_bf16<kCB>(acc, ag[j],
                          b_desc + (step >> 2) * (kCB * 8) + (step & 3) * 2);
        }
      }
      wgmma_commit();
    };
    unsigned a[2][kGroup][4];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) a[0][j][e] = a[1][j][e] = 0u;
    }
    fetch(a[0], 0);
#pragma unroll
    for (int i = 0; i < kGroups; ++i) {
      multiply(a[i & 1], i);
      if (i + 1 < kGroups) {
        wgmma_wait<1>();  // group i - 1 is done with the other registers
#pragma unroll
        for (int j = 0; j < kGroup; ++j) keep_alive(a[(i + 1) & 1][j]);
        fetch(a[(i + 1) & 1], i + 1);
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      keep_alive(a[0][j]);
      keep_alive(a[1][j]);
    }

    // the quad's lanes trade their channel pairs of four tiles, so that lane
    // t stores the 8 channels of tile t: 64 contiguous bytes of voxel g, then
    // of voxel g + 8, a quad
    const int gy = y0 + warp;
    const bool row_ok = gy < Y;
    const int64_t voxel = ((k.b * X + xx) * Y + gy) * Z;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gz = z0 + g + 8 * h;
#pragma unroll
      for (int n4 = 0; n4 < NT; n4 += 4) {
        unsigned v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          v[j] = pack_bf16(acc[4 * (n4 + j) + 2 * h],
                           acc[4 * (n4 + j) + 2 * h + 1]);
        }
        const uint4 tile = quad_transpose(v, t);
        const int co = co0 + (n4 + t) * 8;
        if (row_ok && gz < Z && co < Cout) {
          *reinterpret_cast<uint4*>(out + (voxel + gz) * Cout + co) = tile;
        }
      }
    }
    if (kStats && row_ok) {
#pragma unroll
      for (int nj = 0; nj < NT; ++nj) {
        add_stats(s[nj], ss[nj], acc + 4 * nj, z0 + g < Z, z0 + g + 8 < Z);
      }
    }
    __syncthreads();  // plane xx - 1's slot is free for plane xx + 3
  }

  cp_async_wait<0>();  // the planes fetched past the segment's end
  if (kStats) {
    __syncthreads();  // nothing reads or writes the halos any more
    fold_stats<NT>(reinterpret_cast<float*>(halo), s, ss, warp, kMY, 0, kCB,
                   partial, k, Cout);
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

// K9 "mma". MT: 16-channel tiles of input channels per block (16 MT of
// them), NB: 16-channel pairs of output tiles per warp, WN: groups of 9
// warps along the output channels (16 NB WN output channels a block, past
// Cout zero); 24 MT NB float32 sums a thread. Grid: (cin block, cout block)
// slices x columns (b, x segment, y tile, z tile), z tile fastest. A block
// marches along x through its segment; per output plane xx warp (dx, dz) of
// each group adds the products of its three taps (dx, 0..2, dz) and writes
// them at the end into the block's slice of row `column` of `partial`,
// (columns, 27, Cin, Cout).
template <int MT, int NB, int WN>
__global__ void __launch_bounds__(kDTaps * 32 * WN, 1)
    band_dw_mma_kernel(const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ y,
                       const __nv_bfloat16* __restrict__ gy,
                       const float* __restrict__ a,
                       const float* __restrict__ b2,
                       float* __restrict__ partial, int B, int X, int Y, int Z,
                       int Cin, int Cout, int nyt, int nzt, int segs,
                       int seg_len, int nco, int with_ab) {
  using bf16 = __nv_bfloat16;
  constexpr int kThreads = kDTaps * 32 * WN;
  constexpr int kCI = 16 * MT, kCO = 16 * NB * WN;
  constexpr int CS = kCI + 8;  // voxel stride of a halo: odd x 16 bytes
  constexpr int YS = kCO + 8;  // voxel stride of a yhat tile: the same
  constexpr int kHaloElems = kDHalo * CS;
  constexpr int kTileVox = kDY * kDZ;
  constexpr int kTileElems = kTileVox * YS;
  constexpr int kXP = kCI / 8, kYP = kCO / 8;  // 16-byte pieces per voxel
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);  // [kRing][kDHalo][CS]
  bf16* yh = ring + kRing * kHaloElems;  // [2][kTileVox][YS], yhat
  bf16* ys = yh + 2 * kTileElems;        // [2][kTileVox][YS], y
  __shared__ float a_s[kCO], b_s[kCO];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int64_t columns = static_cast<int64_t>(B) * segs * nyt * nzt;
  const int64_t column = blockIdx.x % columns;
  const int slice = static_cast<int>(blockIdx.x / columns);
  const int co0 = (slice % nco) * kCO, ci0 = (slice / nco) * kCI;
  const int z0 = static_cast<int>(column % nzt) * kDZ;
  const int y0 = static_cast<int>((column / nzt) % nyt) * kDY;
  const int64_t sb = column / (static_cast<int64_t>(nzt) * nyt);
  const int xs = static_cast<int>(sb % segs) * seg_len;
  const int xe = min(X, xs + seg_len);
  const int64_t b = sb / segs;
  // the warp's taps (dx, 0..2, dz) and its first output channel in the block
  const int dx = (warp % kDTaps) / 3, dz = warp % 3;
  const int cw = (warp / kDTaps) * 16 * NB;

  if (with_ab) {
    for (int i = tid; i < kCO; i += kThreads) {
      const bool real = co0 + i < Cout;
      a_s[i] = real ? a[co0 + i] : 0.f;
      b_s[i] = real ? b2[co0 + i] : 0.f;
    }
  }

  // the zero-padded halo of input plane p (-1 .. X), the block's input
  // channels, to ring slot (p + 1) % kRing by cp.async
  auto fetch_plane = [&](int p) {
    bf16* slot = ring + ((p + 1) & (kRing - 1)) * kHaloElems;
    const bool plane = p >= 0 && p < X;
    for (int i = tid; i < kDHalo * kXP; i += kThreads) {
      const int vox = i / kXP, c = i % kXP;
      const int py = y0 + vox / kDHZ - 1, pz = z0 + vox % kDHZ - 1;
      const bool real = plane && py >= 0 && py < Y && pz >= 0 && pz < Z;
      const bf16* src =
          real ? x + (((b * X + p) * Y + py) * Z + pz) * Cin + ci0 + c * 8 : x;
      cp_async16(slot + vox * CS + c * 8, src, real);
    }
  };
  // the gy (and y) tile of output plane p, the block's output channels, to
  // buffer buf; zeros outside the volume and past Cout
  auto fetch_tile = [&](int p, int buf) {
    bf16* hy = yh + buf * kTileElems;
    bf16* hr = ys + buf * kTileElems;
    for (int i = tid; i < kTileVox * kYP; i += kThreads) {
      const int vox = i / kYP, c = i % kYP;
      const int py = y0 + vox / kDZ, pz = z0 + vox % kDZ, co = co0 + c * 8;
      const bool real = py < Y && pz < Z && co < Cout;
      const int64_t off =
          real ? (((b * X + p) * Y + py) * Z + pz) * Cout + co : 0;
      cp_async16(hy + vox * YS + c * 8, gy + off, real);
      if (with_ab) cp_async16(hr + vox * YS + c * 8, y + off, real);
    }
  };
  // yhat = gy + round(a + y * b2), rounded in bfloat16 as on the TPU, in
  // place of gy; zero outside the volume, where round(a) is not
  auto assemble = [&](int buf) {
    bf16* hy = yh + buf * kTileElems;
    const bf16* hr = ys + buf * kTileElems;
    for (int i = tid; i < kTileVox * kYP; i += kThreads) {
      const int vox = i / kYP, c = i % kYP;
      const bool real =
          y0 + vox / kDZ < Y && z0 + vox % kDZ < Z && co0 + c * 8 < Cout;
      uint4* dst = reinterpret_cast<uint4*>(hy + vox * YS + c * 8);
      uint4 gv = *dst;
      const uint4 rv = *reinterpret_cast<const uint4*>(hr + vox * YS + c * 8);
      bf16* ge = reinterpret_cast<bf16*>(&gv);
      const bf16* re = reinterpret_cast<const bf16*>(&rv);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float stat = __bfloat162float(__float2bfloat16_rn(__fadd_rn(
            a_s[c * 8 + j],
            __fmul_rn(__bfloat162float(re[j]), b_s[c * 8 + j]))));
        ge[j] = __float2bfloat16_rn(__bfloat162float(ge[j]) + stat);
      }
      *dst = real ? gv : make_uint4(0u, 0u, 0u, 0u);
    }
  };

  float acc[3][MT][2 * NB][4];  // [dy]
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
      for (int nj = 0; nj < 2 * NB; ++nj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[dy][mi][nj][e] = 0.f;
      }
    }
  }
  // ldmatrix.trans rows of this lane: an A fragment (16 input channels x 16
  // voxels) from a halo row, at voxel column dz + a_k and 8 channels further
  // for lanes 8-15 and 24-31; a pair of B fragments (16 voxels x 16 output
  // channels) from a yhat row, voxel b_k and 8 channels further for the
  // upper lanes
  const int a_k = (lane & 7) + (lane >> 4) * 8;
  const int a_lane = (dz + a_k) * CS + ((lane >> 3) & 1) * 8;
  const int b_k = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int b_lane = b_k * YS + cw + (lane >> 4) * 8;

  for (int p = xs - 1; p <= xs + 1; ++p) fetch_plane(p);
  fetch_tile(xs, 0);
  cp_async_commit();
  for (int xx = xs; xx < xe; ++xx) {
    const int buf = (xx - xs) & 1;
    if (xx + 1 < xe) {  // the next plane's halo and tile
      fetch_plane(xx + 2);
      fetch_tile(xx + 1, buf ^ 1);
    }
    cp_async_commit();
    cp_async_wait<1>();  // planes up to xx + 1 and tile xx have landed
    __syncthreads();
    if (with_ab) {
      assemble(buf);
      __syncthreads();
    }
    // halo row r of input plane xx + dx - 1 meets yhat row r - dy for each
    // dy: one A fragment serves three taps, and the B fragments of the last
    // three yhat rows stay in registers (bw[j]: row r - j)
    const bf16* ha = ring + ((xx + dx) & (kRing - 1)) * kHaloElems + a_lane;
    const bf16* hb = yh + buf * kTileElems + b_lane;
    unsigned bw[3][NB][4];
#pragma unroll
    for (int r = 0; r < kDY + 2; ++r) {
#pragma unroll
      for (int j = 2; j > 0; --j) {
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
          for (int e = 0; e < 4; ++e) bw[j][nb][e] = bw[j - 1][nb][e];
        }
      }
      if (r < kDY) {
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          ldmatrix_x4_trans(bw[0][nb], hb + r * kDZ * YS + nb * 16);
        }
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        unsigned af[4];
        ldmatrix_x4_trans(af, ha + r * kDHZ * CS + mi * 16);
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          if (r - dy >= 0 && r - dy < kDY) {
#pragma unroll
            for (int nb = 0; nb < NB; ++nb) {
              mma_bf16(acc[dy][mi][2 * nb], af, bw[dy][nb][0], bw[dy][nb][1]);
              mma_bf16(acc[dy][mi][2 * nb + 1], af, bw[dy][nb][2],
                       bw[dy][nb][3]);
            }
          }
        }
      }
    }
    __syncthreads();  // plane xx - 1's slot and tile xx's buffer are free
  }
  cp_async_wait<0>();

  // C fragment: input channels g and g + 8 of an m-tile, output channels
  // 2t and 2t + 1 of an n-tile
  float* row = partial + column * 27 * Cin * Cout;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    float* tap =
        row + static_cast<int64_t>((dx * 3 + dy) * 3 + dz) * Cin * Cout;
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      const int ci = ci0 + mi * 16 + g;
#pragma unroll
      for (int nj = 0; nj < 2 * NB; ++nj) {
        const int co = co0 + cw + nj * 8 + 2 * t;
        if (co < Cout) {
          *reinterpret_cast<float2*>(tap + ci * Cout + co) =
              make_float2(acc[dy][mi][nj][0], acc[dy][mi][nj][1]);
          *reinterpret_cast<float2*>(tap + (ci + 8) * Cout + co) =
              make_float2(acc[dy][mi][nj][2], acc[dy][mi][nj][3]);
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

// How the "mma" variant cuts a call: output channels per block, x segments
// (columns of tiles are split along x until the card's 132 SMs have two
// blocks each, as long as a segment keeps 8 planes), taps of weights staged
// at a time (the most of 27, 9, 3, 1 that fit beside the ring), and the
// dynamic shared memory that takes; taps == 0 when nothing fits.
struct MmaPlan {
  int cout_block, nyt, nzt, segs, seg_len, taps;
  size_t smem;
  int64_t rows;  // spatial blocks: the rows of the statistics partials
};

MmaPlan mma_plan(int B, int X, int Y, int Z, int Cin, int Cout) {
  MmaPlan p{};
  p.cout_block = Cout > 32 ? 64 : 32;
  p.nyt = static_cast<int>(ceil_div(Y, kMY));
  p.nzt = static_cast<int>(ceil_div(Z, kMZ));
  const int64_t columns =
      static_cast<int64_t>(B) * p.nyt * p.nzt * ceil_div(Cout, p.cout_block);
  const int64_t want = ceil_div(2 * 132, columns);
  const int64_t most = ceil_div(X, 8);
  p.seg_len = static_cast<int>(ceil_div(X, want < most ? want : most));
  p.segs = static_cast<int>(ceil_div(X, p.seg_len));
  p.rows = static_cast<int64_t>(B) * p.segs * p.nyt * p.nzt;
  const size_t ring = sizeof(__nv_bfloat16) * kRing * kMHalo * (Cin + 8);
  for (int taps : {27, 9, 3, 1}) {
    const size_t bytes =
        ring + sizeof(__nv_bfloat16) * taps * Cin * p.cout_block;
    if (bytes <= static_cast<size_t>(kMaxSmem)) {
      p.taps = taps;
      p.smem = bytes;
      break;
    }
  }
  return p;
}

bool mma_takes(int Cin, int Cout, int dtype) {
  return dtype == kBFloat16 && Cin % 16 == 0 && Cin <= 128 && Cout % 8 == 0;
}

template <int NT>
int launch_band_conv_mma(const void* x, const void* w, void* out,
                         void* partial, void* stats, int B, int X, int Y,
                         int Z, int Cin, int Cout, int with_stats,
                         const MmaPlan& p, cudaStream_t st) {
  using T = __nv_bfloat16;
  const int64_t blocks = p.rows * ceil_div(Cout, p.cout_block);
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = with_stats ? band_conv_mma_kernel<NT, true>
                           : band_conv_mma_kernel<NT, false>;
  const cudaError_t status = allow_smem(kernel, p.smem);
  if (status != cudaSuccess) return static_cast<int>(status);
  kernel<<<static_cast<unsigned>(blocks), kThreads, p.smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out),
      static_cast<float*>(partial), B, X, Y, Z, Cin, Cout, p.nyt, p.nzt,
      p.segs, p.seg_len, p.taps);
  if (with_stats) {
    reduce_rows(static_cast<const float*>(partial), static_cast<float*>(stats),
                p.rows, Cout, 2, st);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int NT, int CIN>
int launch_band_conv_wgmma(const void* x, const void* w, void* out,
                           void* partial, void* stats, int B, int X, int Y,
                           int Z, int Cout, int with_stats, const MmaPlan& p,
                           cudaStream_t st) {
  using T = __nv_bfloat16;
  const int64_t blocks = p.rows * ceil_div(Cout, p.cout_block);
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(T) * (wgmma_weight_elems(CIN, 8 * NT) +
                                   kRing * kMHalo * (CIN + 8));
  auto kernel = with_stats ? band_conv_wgmma_kernel<NT, true, CIN>
                           : band_conv_wgmma_kernel<NT, false, CIN>;
  const cudaError_t status = allow_smem(kernel, smem);
  if (status != cudaSuccess) return static_cast<int>(status);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<T*>(out), static_cast<float*>(partial), B, X, Y, Z, Cout,
      p.nyt, p.nzt, p.segs, p.seg_len);
  if (with_stats) {
    reduce_rows(static_cast<const float*>(partial), static_cast<float*>(stats),
                p.rows, Cout, 2, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// How K9 cuts a call. "direct": 32 x 32 channel slices per dx, G position
// groups sharing out kDwBlocks blocks (at least 1, at most one a plane).
// "mma": input channels in blocks of 32 (16 where Cin is an odd multiple of
// 16), output channels in blocks of 16 NB WN: two groups of 9 warps of 16
// (or, with 16 input channels, 32) channels where Cout needs them, so that
// a warp holds 48 sums at most; columns of voxel tiles split along x until
// the card's 132 SMs have four blocks each, as long as a segment keeps 8
// planes. `rows`: rows of the partials, the groups or the columns.
struct DwPlan {
  int mt, nb, wn, nci, nco, nyt, nzt, segs, seg_len;
  int64_t rows;
};

DwPlan dw_plan(int B, int X, int Y, int Z, int Cin, int Cout, int variant) {
  DwPlan p{};
  if (variant == 1) {
    p.mt = Cin % 32 == 0 ? 2 : 1;
    p.nb = p.mt == 1 && Cout > 32 ? 2 : 1;
    p.wn = Cout > 16 * p.nb ? 2 : 1;
    p.nci = Cin / (16 * p.mt);
    p.nco = static_cast<int>(ceil_div(Cout, 16 * p.nb * p.wn));
    p.nyt = static_cast<int>(ceil_div(Y, kDY));
    p.nzt = static_cast<int>(ceil_div(Z, kDZ));
    const int64_t per_plane =
        static_cast<int64_t>(B) * p.nyt * p.nzt * p.nci * p.nco;
    const int64_t want = ceil_div(4 * 132, per_plane);
    const int64_t most = ceil_div(X, 8);
    p.seg_len = static_cast<int>(ceil_div(X, want < most ? want : most));
    p.segs = static_cast<int>(ceil_div(X, p.seg_len));
    p.rows = static_cast<int64_t>(B) * p.segs * p.nyt * p.nzt;
    return p;
  }
  p.nci = static_cast<int>(ceil_div(Cin, kWC));
  p.nco = static_cast<int>(ceil_div(Cout, kWC));
  p.nyt = static_cast<int>(ceil_div(Y, kWY));
  p.nzt = static_cast<int>(ceil_div(Z, kWZ));
  const int64_t most = kDwBlocks / (3LL * p.nci * p.nco);
  const int64_t planes = static_cast<int64_t>(B) * X;
  p.rows = most < 1 ? 1 : (most < planes ? most : planes);
  return p;
}

bool dw_mma_takes(int Cin, int Cout, int dtype) {
  return dtype == kBFloat16 && Cin % 16 == 0 && Cout % 8 == 0;
}

template <int MT, int NB, int WN>
int launch_band_dw_mma(const void* x, const void* y, const void* gy,
                       const void* a, const void* b2, void* partial, int B,
                       int X, int Y, int Z, int Cin, int Cout, int with_ab,
                       const DwPlan& p, cudaStream_t st) {
  using T = __nv_bfloat16;
  constexpr int kCO = 16 * NB * WN;
  const int64_t blocks = p.rows * p.nci * p.nco;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t tile = static_cast<size_t>(kDY) * kDZ * (kCO + 8);
  const size_t smem =
      sizeof(T) * (static_cast<size_t>(kRing) * kDHalo * (16 * MT + 8) +
                   2 * (with_ab ? 2 : 1) * tile);
  auto kernel = band_dw_mma_kernel<MT, NB, WN>;
  // the limit counts the kernel's static a and b2 as well
  const cudaError_t status = allow_smem(kernel, smem + sizeof(float) * 2 * kCO);
  if (status != cudaSuccess) return static_cast<int>(status);
  kernel<<<static_cast<unsigned>(blocks), kDTaps * 32 * WN, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const T*>(gy), static_cast<const float*>(a),
      static_cast<const float*>(b2), static_cast<float*>(partial), B, X, Y, Z,
      Cin, Cout, p.nyt, p.nzt, p.segs, p.seg_len, p.nco, with_ab);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace transmf

// Spatial blocks of K8 for a call, i.e. the rows of its statistics partials.
// variant: 0 "direct", 1 "mma".
extern "C" int64_t transmf_band_blocks(int B, int X, int Y, int Z, int Cin,
                                       int Cout, int variant) {
  using namespace transmf;
  if (variant == 1) return mma_plan(B, X, Y, Z, Cin, Cout).rows;
  return static_cast<int64_t>(B) * X * ceil_div(Y, kFY) * ceil_div(Z, kFZ);
}

// K8. x: (B, X, Y, Z, Cin); w: (3, 3, 3, Cin, Cout) in x's type; out:
// (B, X, Y, Z, Cout). with_stats: also stats, float32 (2, Cout) [sum, sum of
// squares] of the float32 accumulators over B, X, Y, Z, through partial, a
// float32 scratch of 2 * transmf_band_blocks(...) * Cout (both unused
// otherwise). variant 1 ("mma") needs bfloat16, Cin % 16 == 0, Cin <= 128,
// Cout % 8 == 0 and 16-byte aligned x, w and out; variant 0 ("direct") takes
// everything.
extern "C" int transmf_band_conv(const void* x, const void* w, void* out,
                                 void* partial, void* stats, int B, int X,
                                 int Y, int Z, int Cin, int Cout,
                                 int with_stats, int dtype, int variant,
                                 void* stream) {
  using namespace transmf;
  if (bad_volume(B, X, Y, Z, Cin, Cout) || variant < 0 || variant > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  if (variant == 1) {
    const auto misaligned = [](const void* p) {
      return reinterpret_cast<uintptr_t>(p) % 16 != 0;
    };
    const MmaPlan p = mma_plan(B, X, Y, Z, Cin, Cout);
    if (!mma_takes(Cin, Cout, dtype) || p.taps == 0 || misaligned(x) ||
        misaligned(w) || misaligned(out)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    // the models' widths, whose weights stay resident, take the wgmma kernel
    // compiled for their Cin
    const auto wgmma = [&](auto nt, auto cin) {
      return launch_band_conv_wgmma<decltype(nt)::value, decltype(cin)::value>(
          x, w, out, partial, stats, B, X, Y, Z, Cout, with_stats, p, st);
    };
    constexpr std::integral_constant<int, 4> nt4{};
    constexpr std::integral_constant<int, 8> nt8{};
    constexpr std::integral_constant<int, 32> cin32{};
    constexpr std::integral_constant<int, 64> cin64{};
    if (p.taps == 27 && Cin == 32) {
      return p.cout_block == 64 ? wgmma(nt8, cin32) : wgmma(nt4, cin32);
    }
    if (p.taps == 27 && Cin == 64 && p.cout_block == 32) {
      return wgmma(nt4, cin64);
    }
    if (p.cout_block == 64) {
      return launch_band_conv_mma<8>(x, w, out, partial, stats, B, X, Y, Z,
                                        Cin, Cout, with_stats, p, st);
    }
    return launch_band_conv_mma<4>(x, w, out, partial, stats, B, X, Y, Z,
                                      Cin, Cout, with_stats, p, st);
  }
  const int J = Cout > 32 ? 2 : 1;
  if (transmf_band_blocks(B, X, Y, Z, Cin, Cout, 0) * ceil_div(Cout, 32 * J) >
      2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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

// Rows of K9's float32 partials for a call. variant: 0 "direct", 1 "mma".
extern "C" int64_t transmf_band_dw_rows(int B, int X, int Y, int Z, int Cin,
                                        int Cout, int variant) {
  return transmf::dw_plan(B, X, Y, Z, Cin, Cout, variant).rows;
}

// K9. x: (B, X, Y, Z, Cin); gy (and y when with_ab): (B, X, Y, Z, Cout) in
// x's type; a, b2: float32 (Cout,), read when with_ab; dw: float32
// (3, 3, 3, Cin, Cout); partial: float32 scratch of
// transmf_band_dw_rows(...) * 27 * Cin * Cout. variant 1 ("mma") needs
// bfloat16, Cin % 16 == 0, Cout % 8 == 0 and 16-byte aligned x, y, gy;
// variant 0 ("direct") takes everything.
extern "C" int transmf_band_dw(const void* x, const void* y, const void* gy,
                               const void* a, const void* b2, void* partial,
                               void* dw, int B, int X, int Y, int Z, int Cin,
                               int Cout, int with_ab, int dtype, int variant,
                               void* stream) {
  using namespace transmf;
  if (bad_volume(B, X, Y, Z, Cin, Cout) || variant < 0 || variant > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const DwPlan p = dw_plan(B, X, Y, Z, Cin, Cout, variant);
  if (variant == 1) {
    const auto misaligned = [](const void* ptr) {
      return reinterpret_cast<uintptr_t>(ptr) % 16 != 0;
    };
    if (!dw_mma_takes(Cin, Cout, dtype) || misaligned(x) || misaligned(gy) ||
        (with_ab && misaligned(y))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const auto run = [&](auto mt, auto nb, auto wn) {
      return launch_band_dw_mma<decltype(mt)::value, decltype(nb)::value,
                                decltype(wn)::value>(
          x, y, gy, a, b2, partial, B, X, Y, Z, Cin, Cout, with_ab, p, st);
    };
    using I1 = std::integral_constant<int, 1>;
    using I2 = std::integral_constant<int, 2>;
    int status = static_cast<int>(cudaErrorInvalidValue);
    switch (p.mt * 100 + p.nb * 10 + p.wn) {
      case 111: status = run(I1{}, I1{}, I1{}); break;
      case 112: status = run(I1{}, I1{}, I2{}); break;
      case 122: status = run(I1{}, I2{}, I2{}); break;
      case 211: status = run(I2{}, I1{}, I1{}); break;
      case 212: status = run(I2{}, I1{}, I2{}); break;
      default: break;
    }
    if (status != cudaSuccess) return status;
    reduce_rows(static_cast<const float*>(partial), static_cast<float*>(dw),
                p.rows, 27 * Cin * Cout, 1, st);
    return static_cast<int>(cudaGetLastError());
  }
  const int G = static_cast<int>(p.rows);
  const int64_t blocks = static_cast<int64_t>(G) * 3 * p.nci * p.nco;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(dtype, [&](auto tag) {
    using T = decltype(tag);
    auto kernel = with_ab ? band_dw_kernel<T, true> : band_dw_kernel<T, false>;
    kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(y),
        static_cast<const T*>(gy), static_cast<const float*>(a),
        static_cast<const float*>(b2), static_cast<float*>(partial), B, X, Y, Z,
        Cin, Cout, p.nyt, p.nzt, p.nci, p.nco, G);
    reduce_rows(static_cast<const float*>(partial), static_cast<float*>(dw), G,
                27 * Cin * Cout, 1, st);
  });
}
