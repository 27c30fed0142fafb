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
// 462 MB, against 6.2 GFMA of float32 work. On the CUDA cores those FMAs
// alone take longer than the stores (0.19 against 0.14 ms; 1.12 against
// 0.85 ms at 182x218x182), so only the tensor cores can make the kernel
// store-bound. Two variants, chosen by the caller from the dtype and C
// alone (ops/stem.py::conv_variant) and refused here when they do not fit:
//
// K3 / K5 "direct" (float32, and bfloat16 with other channel counts): one
// block per brick of one x-plane, kTY y-rows and kTZ z-columns.
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
// ~250 MB of scratch at the training shape. "direct" issues about three
// shared loads per FMA and 2-byte stores at a stride of C: 17-18% of HBM's
// rate (PERF.md).
//
// K3 / K5 "mma" (bfloat16, C % 16 == 0, C <= 64): an implicit GEMM on
// mma.sync.m16n8k16 per tile row of 16 z voxels at one (x, y):
// out[16 voxels][C] = A[16 voxels][32 taps] B[32 taps][C], the 27 taps in
// K6's mma_tap order and padded with zero rows in A and in B (0 x NaN would
// be NaN). A block walks a column of 32 x 16 (y, z) tiles along a segment
// of x with K6 "mma"'s halo machinery (StemHalo below): A is K6's A
// transposed, the same tap rows read with ldmatrix.trans; B sits in shared
// memory for the whole block. Plane x + 2's raw x rows arrive by cp.async
// while plane x's products and stores run. A tile row's output is one
// contiguous run of 16 C bfloat16 wherever it lies in Z: each float32
// accumulator is rounded once (as "direct" does; only the order of the
// float32 sum differs), quads exchange their fragments so that each lane
// stores 16 (or, for a last pair of n-tiles, 8) contiguous bytes with the
// streaming hint, and voxels past Y and Z are neither stored nor summed
// (they are not zero: their neighbours inside are not). K5's thread keeps the
// sums of its channels in registers over the segment; the block adds them
// over lanes in a butterfly and over warps in order into one (2, C) row of
// partials, which reduce_rows adds in a fixed order: the sums repeat bit
// for bit. It reaches about two thirds of HBM's rate: a store-only loop of
// the same tiles on the card writes at about nine tenths, so what is left
// is the kernel's per-plane round of barriers and halo builds (PERF.md).
//
// K6 replaces _stem_dw_kernel and _stem_dw_blocked_kernel (pallas_calls at
// stem.py:332 and :470):
//   dw[dx, dy, dz, c] = sum over b, x, y, z of
//       xpad[b, x+dx, y+dy, z+dz] * yhat[b, x, y, z, c],
//   yhat = gy + round(a[c] + y * b2[c])   (the BN-statistics cotangents)
// with float32 sums. Bound by reading y and gy (924 MB in bf16 at the stage-1
// training shape, 5.5 GB at full resolution). The TPU kernel's banded MXU
// form (T = lhs^T @ yhat, then the diagonals) is not carried over. Two
// variants, chosen by the caller from the dtype and C alone
// (ops/stem.py::dw_variant) and refused here when they do not fit:
//
// K6 "direct" (float32, and bfloat16 with other channel counts): a block
// stages the input halo of a brick like K3 and walks kXC x-planes; thread
// (position group, channel) forms yhat in registers and keeps 27 float32 tap
// sums for its channel. The block adds its position groups in order and
// writes one (27, C) partial; reduce_rows adds those in a fixed order. One
// broadcast shared-memory load feeds each FMA, a warp keeps about one voxel
// of y and gy in flight, and the halo is staged between two barriers: it
// reaches a fifth of HBM's rate (PERF.md).
//
// K6 "mma" (bfloat16, C % 16 == 0, C <= 64): a GEMM on mma.sync.m16n8k16
// with a huge K, M = 27 taps (padded to 32) x N = C channels x K = voxels.
// This orientation puts the single input channel on the tap axis, where
// K9's (M = taps x Cin) would need Cin % 16; yhat, channels-last, is the B
// operand as K9 reads it. A block of 8 warps owns a column of 16 x 16 (y, z)
// voxel tiles of one sample and marches along a segment of x (segments from
// the shape alone, so that the grid holds about 8 blocks an SM). Per plane:
//   - the y and gy tiles of plane x + 2 (and the raw x rows of plane x + 3)
//     arrive by 16-byte cp.async into a two-stage ring while plane x's
//     products run: 32 KB a block in flight at C = 32, and y, gy are read
//     exactly once;
//   - the block assembles yhat with the direct kernel's rounding
//     (__fmul_rn / __fadd_rn, round to bfloat16, add gy, round), zero outside
//     the volume, where round(a) is not;
//   - the A operand, [tap][16 voxels], is a row of the zero-padded x halo
//     starting at z + dz, not 16-byte aligned for dz = 1, 2: each halo plane
//     is kept as three copies shifted by dz, so that every tap row is an
//     aligned ldmatrix row. Tap rows are ordered by dx in groups of eight
//     ((dy, dz) = (0, 0) .. (2, 1)), the three (dx, 2, 2) and five zero rows
//     last, and the strides (3, 57, 177 units of 16 bytes for a row, a dz
//     copy, a plane) put the eight rows of every ldmatrix on distinct banks;
//   - warp w takes tile rows w and w + 8: per row two ldmatrix for A, C / 16
//     ldmatrix.trans for B (voxel stride C + 8, an odd multiple of 16 bytes),
//     and C / 4 products, into a 32 x C float32 table in its registers.
// At the end the block adds its 8 warps' tables in order and writes one
// (27, C) row of partials; reduce_rows adds the rows in a fixed order: no
// float atomics, so dw repeats bit for bit. bfloat16 products are exact in
// float32: only the order of the float32 sums differs from "direct".
#include <initializer_list>
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

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

// K6 "mma" tiling: a tile of kSY rows of kSZ voxels (one product's depth);
// K3 / K5 "mma" take tiles of kFY rows of kSZ voxels (16, the product's M)
constexpr int kSY = 16;
constexpr int kFY = 32;
constexpr int kSZ = 16;
constexpr int kSVox = kSY * kSZ;
constexpr int kSWarps = 8;
constexpr int kSThreads = 32 * kSWarps;
constexpr int kRawRow = 32;  // raw x elements staged per halo row
constexpr int kStemMmaBlocks = 8 * 132;  // blocks the segments aim for

// The smallest n' >= n with n' % 8 == 1.
__host__ __device__ constexpr int up_to_1_mod_8(int n) {
  return n + (9 - n % 8) % 8;
}

// Row m of the tap axis of the product (M for K6, K for K3 / K5) -> its tap
// (dx * 9 + dy * 3 + dz), or -1 (zero).
__device__ __forceinline__ int mma_tap(int m) {
  const int group = m / 8, j = m % 8;
  if (group < 3) return group * 9 + j;
  return j < 3 ? j * 9 + 8 : -1;
}

// The x halo of a column of kRows x 16 (y, z) voxel tiles of sample b,
// plane by plane, as K6 "mma" (kRows 16) and K3 / K5 "mma" (32) read it:
// each tap row starts at z + dz, not 16-byte aligned for dz = 1, 2, so halo
// plane p (-1 .. X) is kept as three copies shifted by dz in copy slot
// (p + 1) % 3 (slot 3 holds the zero rows). x's rows are not aligned either
// (364 bytes at Z = 182): a halo row arrives by cp.async as four 16-byte
// chunks from the aligned-down address into raw slot p & 1, and the copies
// are built from them with the SAME padding masked in. Every thread of the
// block calls each member.
template <int kRows>
struct StemHalo {
  static constexpr int kHalo = kRows + 2;  // rows of a plane's x halo
  // The shifted x copies, in 16-byte units: a row of 16 bfloat16 (2 units)
  // padded to 3, a dz copy of kHalo rows and a plane of three copies each
  // padded to 1 modulo 8 (57 and 177 for 16 rows). Strides of 3, 1 and 1
  // modulo 8 keep the eight rows of each ldmatrix on distinct banks.
  static constexpr int kRowU = 3;
  static constexpr int kCopyU = up_to_1_mod_8(kHalo * kRowU);
  static constexpr int kPlaneU = up_to_1_mod_8(3 * kCopyU);
  static constexpr int kCopyElems = 4 * kPlaneU * 8;  // slots 0 .. 3
  static constexpr int kRawElems = kHalo * kRawRow;   // one raw slot

  const __nv_bfloat16* x;
  __nv_bfloat16* copies;  // [4][kPlaneU x 8]
  __nv_bfloat16* raw;     // [2][kHalo][kRawRow]
  int64_t b;
  int X, Y, Z, y0, z0, tid;

  // The ldmatrix row of tap row m at voxel offset 8 * half, in 16-byte
  // units from the start of its copy slot: tap (dx, dy, dz) is row dy (+ the
  // tile row) of the copy of plane x + dx - 1 shifted by dz; `dx` is set to
  // -1 for the zero rows, which sit in slot 3 at banks 3 .. 7 past the real
  // rows of group 3.
  static __device__ int tap_row(int m, int half, int& dx) {
    const int tap = mma_tap(m);
    if (tap < 0) {
      dx = -1;
      return 2 * kCopyU + 2 * kRowU + (m % 8 - 3) + half;
    }
    dx = tap / 9;
    return (tap % 3) * kCopyU + ((tap / 3) % 3) * kRowU + half;
  }

  __device__ void zero_pad() const {  // slot 3: zero rows
    for (int i = tid; i < kPlaneU; i += kSThreads) {
      reinterpret_cast<uint4*>(copies + 3 * kPlaneU * 8)[i] =
          make_uint4(0u, 0u, 0u, 0u);
    }
  }

  // x row py of plane p (inside the volume): its first element, and the
  // 16-byte aligned address its staged raw chunks start from, as an element
  // offset from x (possibly negative: x need only be 2-byte aligned)
  __device__ int64_t raw_start(int p, int py, int64_t& rowbase) const {
    rowbase = ((b * X + p) * Y + py) * static_cast<int64_t>(Z);
    const uintptr_t first = reinterpret_cast<uintptr_t>(
        x + rowbase + (z0 > 0 ? z0 - 1 : 0));
    return static_cast<int64_t>(
               static_cast<intptr_t>((first & ~uintptr_t{15}) -
                                     reinterpret_cast<uintptr_t>(x))) /
           2;
  }

  // the x halo rows of plane p (-1 .. X) that lie in the volume, as four
  // 16-byte chunks a row, to raw slot p & 1; chunks outside the row's
  // z0 - 1 .. z0 + 16 are zero-filled and read nothing
  __device__ void fetch_raw(int p) const {
    if (p < 0 || p >= X) return;
    __nv_bfloat16* slot = raw + (p & 1) * kRawElems;
    for (int i = tid; i < kHalo * 4; i += kSThreads) {
      const int hr = i / 4, ch = i % 4, py = y0 - 1 + hr;
      if (py < 0 || py >= Y) continue;
      int64_t rowbase;
      const int64_t start = raw_start(p, py, rowbase) + ch * 8;
      const int64_t hi = rowbase + min(z0 + kSZ + 1, Z);
      const int64_t lo = rowbase + (z0 > 0 ? z0 - 1 : 0);
      const bool real = start < hi && start + 8 > lo;
      cp_async16(slot + hr * kRawRow + ch * 8, real ? x + start : x, real);
    }
  }

  // the three copies of plane p's halo, shifted by dz, to copy slot
  // (p + 1) % 3: copy dz, row hr, element k = xpad[p, y0 + hr, z0 + dz + k],
  // one 16-byte unit (8 elements) a thread
  __device__ void build(int p) const {
    __nv_bfloat16* slot = copies + ((p + 1) % 3) * kPlaneU * 8;
    const __nv_bfloat16* src = raw + (p & 1) * kRawElems;
    const bool plane = p >= 0 && p < X;
    for (int i = tid; i < kHalo * 3 * 2; i += kSThreads) {
      const int hr = i / 6, dz = (i / 2) % 3, k = 8 * (i % 2);
      const int py = y0 - 1 + hr;
      uint4 unit = make_uint4(0u, 0u, 0u, 0u);
      if (plane && py >= 0 && py < Y) {
        int64_t rowbase;
        const int64_t start = raw_start(p, py, rowbase);
        const int z = z0 - 1 + dz + k;  // of the unit's first element
        const int at = hr * kRawRow + static_cast<int>(rowbase + z - start);
        __nv_bfloat16* v = reinterpret_cast<__nv_bfloat16*>(&unit);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          if (z + e >= 0 && z + e < Z) v[e] = src[at + e];
        }
      }
      *reinterpret_cast<uint4*>(slot + (dz * kCopyU + hr * kRowU) * 8 + k) =
          unit;
    }
  }

  // the ldmatrix row `off` (from tap_row) of plane xx + dx - 1's copies
  __device__ const __nv_bfloat16* row(int xx, int dx, int off) const {
    const int slot = dx < 0 ? 3 : (xx + dx) % 3;
    return copies + (slot * kPlaneU + off) * 8;
  }
};

// Shared memory of K6 "mma" at C channels: the y / gy ring, yhat, four x
// copy slots and two raw x slots, in bytes.
constexpr int stem_dw_mma_smem(int C) {
  return 2 * 2 * kSVox * C * 2 + kSVox * (C + 8) * 2 +
         2 * (StemHalo<kSY>::kCopyElems + 2 * StemHalo<kSY>::kRawElems);
}

// K6 "mma". Block `row` = ((b * segs + seg) * nyt + yt) * nzt + zt marches
// through planes [seg * seg_len, +seg_len) of column (b, yt, zt) and writes
// row `row` of `partial`, (rows, 27, C).
template <int C>
__global__ void __launch_bounds__(kSThreads, C <= 32 ? 2 : 1)
    stem_dw_mma_kernel(const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ y,
                       const __nv_bfloat16* __restrict__ gy,
                       const float* __restrict__ a,
                       const float* __restrict__ b2,
                       float* __restrict__ partial, int X, int Y, int Z,
                       int nyt, int nzt, int segs, int seg_len) {
  using bf16 = __nv_bfloat16;
  using Halo = StemHalo<kSY>;
  constexpr int YS = C + 8;      // voxel stride of yhat: odd x 16 bytes
  constexpr int kP = C / 8;      // 16-byte pieces of a voxel; n-tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* stage = reinterpret_cast<bf16*>(smem_raw);  // [2][y, gy][kSVox][C]
  bf16* yhat = stage + 2 * 2 * kSVox * C;           // [kSVox][YS]
  bf16* copies = yhat + kSVox * YS;                 // Halo::kCopyElems
  bf16* raw = copies + Halo::kCopyElems;            // [2] Halo::kRawElems
  __shared__ float a_s[C], b_s[C];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int64_t row = blockIdx.x;
  const int z0 = static_cast<int>(row % nzt) * kSZ;
  const int y0 = static_cast<int>((row / nzt) % nyt) * kSY;
  const int64_t sb = row / (static_cast<int64_t>(nzt) * nyt);
  const int xs = static_cast<int>(sb % segs) * seg_len;
  const int xe = min(X, xs + seg_len);
  const int64_t b = sb / segs;
  const Halo h{x, copies, raw, b, X, Y, Z, y0, z0, tid};

  for (int i = tid; i < C; i += kSThreads) {
    a_s[i] = a[i];
    b_s[i] = b2[i];
  }
  h.zero_pad();

  // the y and gy tiles of plane p to stage s; zeros outside the volume
  auto fetch_tile = [&](int p, int s) {
    bf16* sy = stage + s * 2 * kSVox * C;
    bf16* sg = sy + kSVox * C;
    for (int i = tid; i < kSVox * kP; i += kSThreads) {
      const int vox = i / kP, c = i % kP;
      const int py = y0 + vox / kSZ, pz = z0 + vox % kSZ;
      const bool real = py < Y && pz < Z;
      const int64_t off =
          real ? (((b * X + p) * Y + py) * Z + pz) * C + c * 8 : 0;
      cp_async16(sy + vox * C + c * 8, y + off, real);
      cp_async16(sg + vox * C + c * 8, gy + off, real);
    }
  };
  // yhat = gy + round(a + y * b2), rounded in bfloat16 as on the TPU; zero
  // outside the volume, where round(a) is not
  auto assemble = [&](int s) {
    const bf16* sy = stage + s * 2 * kSVox * C;
    const bf16* sg = sy + kSVox * C;
    for (int i = tid; i < kSVox * kP; i += kSThreads) {
      const int vox = i / kP, c = i % kP;
      const bool real = y0 + vox / kSZ < Y && z0 + vox % kSZ < Z;
      const uint4 rv = *reinterpret_cast<const uint4*>(sy + vox * C + c * 8);
      uint4 gv = *reinterpret_cast<const uint4*>(sg + vox * C + c * 8);
      const bf16* re = reinterpret_cast<const bf16*>(&rv);
      bf16* ge = reinterpret_cast<bf16*>(&gv);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float stat = __bfloat162float(__float2bfloat16_rn(__fadd_rn(
            a_s[c * 8 + j],
            __fmul_rn(__bfloat162float(re[j]), b_s[c * 8 + j]))));
        ge[j] = __float2bfloat16_rn(__bfloat162float(ge[j]) + stat);
      }
      *reinterpret_cast<uint4*>(yhat + vox * YS + c * 8) =
          real ? gv : make_uint4(0u, 0u, 0u, 0u);
    }
  };

  // ldmatrix rows of this lane. A (m-tile mt): M row m = 16 mt + lane % 16
  // at voxel offset 8 (lane / 16). B: yhat voxel b_k of a tile row, 8
  // channels further for the upper lanes.
  int a_dx[2], a_off[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    a_off[mt] = Halo::tap_row(16 * mt + lane % 16, lane / 16, a_dx[mt]);
  }
  const int b_k = (lane & 7) + ((lane >> 3) & 1) * 8;
  const bf16* b_lane = yhat + b_k * YS + (lane >> 4) * 8;

  float acc[2][kP][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < kP; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    }
  }

  // planes xs - 1 and xs built; tiles xs and xs + 1 (with the raw rows of
  // planes xs + 1 and xs + 2) in flight, one commit group a tile
  h.fetch_raw(xs - 1);
  h.fetch_raw(xs);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  h.build(xs - 1);
  h.build(xs);
  __syncthreads();  // raw slots free
  fetch_tile(xs, 0);
  h.fetch_raw(xs + 1);
  cp_async_commit();
  if (xs + 1 < xe) {
    fetch_tile(xs + 1, 1);
    h.fetch_raw(xs + 2);
  }
  cp_async_commit();
  for (int xx = xs; xx < xe; ++xx) {
    const int s = (xx - xs) & 1;
    cp_async_wait<1>();  // tile xx and plane xx + 1's raw rows have landed
    __syncthreads();     // ... for every thread; plane xx - 1's products done
    assemble(s);
    h.build(xx + 1);
    __syncthreads();
    if (xx + 2 < xe) {  // stage s and raw slot (xx + 1) & 1 are free
      fetch_tile(xx + 2, s);
      h.fetch_raw(xx + 3);
    }
    cp_async_commit();
    const bf16* pa[2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) pa[mt] = h.row(xx, a_dx[mt], a_off[mt]);
#pragma unroll
    for (int i = 0; i < kSY / kSWarps; ++i) {
      const int r = warp + i * kSWarps;
      unsigned af[2][4];
      ldmatrix_x4(af[0], pa[0] + r * Halo::kRowU * 8);
      ldmatrix_x4(af[1], pa[1] + r * Halo::kRowU * 8);
#pragma unroll
      for (int np = 0; np < kP / 2; ++np) {
        unsigned bf[4];
        ldmatrix_x4_trans(bf, b_lane + r * kSZ * YS + np * 16);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][2 * np], af[mt], bf[0], bf[1]);
          mma_bf16(acc[mt][2 * np + 1], af[mt], bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // the warps' 32 x C tables, then their sum in warp order, once a tap
  float* table = reinterpret_cast<float*>(smem_raw);  // [kSWarps][32][C]
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < kP; ++nt) {
      float* p = table + (warp * 32 + 16 * mt + g) * C + nt * 8 + 2 * t;
      *reinterpret_cast<float2*>(p) = make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<float2*>(p + 8 * C) =
          make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
  __syncthreads();
  float* out = partial + row * 27 * C;
  for (int i = tid; i < 32 * C; i += kSThreads) {
    const int tap = mma_tap(i / C);
    if (tap < 0) continue;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kSWarps; ++w) sum += table[w * 32 * C + i];
    out[tap * C + i % C] = sum;
  }
}

// K3 / K5 "mma"'s B in shared memory: [channel][32 taps], 80-byte rows
constexpr int kWRow = 40;

// K3 "mma" (kStats false) and K5 "mma" (kStats true). Block `row` (as K6
// "mma", with tiles of kFY rows) marches through planes [seg * seg_len,
// +seg_len) of column (b, yt, zt); warp w makes tile rows w, w + 8, w + 16
// and w + 24 of each plane, each 16 z voxels at one y:
// out[16 voxels][C] = A[16 voxels][32 taps] B[32 taps][C]
// on two k-steps of mma.sync.m16n8k16. With kStats the block writes row
// `row` of `partial`, (2, rows, C): the sums and sums of squares of the
// float32 accumulators of its voxels inside the volume.
template <int C, bool kStats>
__global__ void __launch_bounds__(kSThreads, C <= 32 ? 3 : 2)
    stem_conv_mma_kernel(const __nv_bfloat16* __restrict__ x,
                         const __nv_bfloat16* __restrict__ w,
                         __nv_bfloat16* __restrict__ out,
                         float* __restrict__ partial, int X, int Y, int Z,
                         int nyt, int nzt, int segs, int seg_len) {
  using bf16 = __nv_bfloat16;
  constexpr int kNT = C / 8;  // n-tiles
  using Halo = StemHalo<kFY>;
  __shared__ __align__(16) bf16 copies[Halo::kCopyElems];
  __shared__ __align__(16) bf16 raw[2 * Halo::kRawElems];
  __shared__ __align__(16) bf16 wsm[C * kWRow];
  __shared__ float red[kStats ? kSWarps : 1][2][C];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int64_t row = blockIdx.x;
  const int z0 = static_cast<int>(row % nzt) * kSZ;
  const int y0 = static_cast<int>((row / nzt) % nyt) * kFY;
  const int64_t sb = row / (static_cast<int64_t>(nzt) * nyt);
  const int xs = static_cast<int>(sb % segs) * seg_len;
  const int xe = min(X, xs + seg_len);
  const int64_t b = sb / segs;
  const Halo h{x, copies, raw, b, X, Y, Z, y0, z0, tid};
  h.zero_pad();

  // B, stored [n][k] (taps in mma_tap order, zero past the 27): rows of 80
  // bytes, 5 units, put the eight rows of each ldmatrix on distinct banks.
  // Lane l reads channel l % 8 + 8 (l / 16) at tap offset 8 ((l / 8) % 2):
  // the fragments of two n-tiles of one k-step.
  for (int i = tid; i < C * 32; i += kSThreads) {
    const int n = i / 32, tap = mma_tap(i % 32);
    wsm[n * kWRow + i % 32] =
        tap < 0 ? __float2bfloat16_rn(0.f) : w[tap * C + n];
  }
  const bf16* b_lane =
      wsm + (lane % 8 + 8 * (lane / 16)) * kWRow + 8 * ((lane / 8) % 2);
  // A, k-step s, read with .trans from the tap rows: lane l addresses
  // matrix l / 8 = (voxels 0-7, k 0-7), (8-15, 0-7), (0-7, 8-15),
  // (8-15, 8-15), row l % 8
  int a_dx[2], a_off[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    a_off[s] = Halo::tap_row(16 * s + lane % 8 + 8 * (lane / 16),
                             (lane / 8) % 2, a_dx[s]);
  }

  float sum[kNT][2], sq[kNT][2];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    sum[nt][0] = sum[nt][1] = sq[nt][0] = sq[nt][1] = 0.f;
  }

  // planes xs - 1 and xs built, plane xs + 1's raw rows in flight
  h.fetch_raw(xs - 1);
  h.fetch_raw(xs);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  h.build(xs - 1);
  h.build(xs);
  __syncthreads();  // raw slots free
  h.fetch_raw(xs + 1);
  cp_async_commit();
  for (int xx = xs; xx < xe; ++xx) {
    cp_async_wait<0>();  // plane xx + 1's raw rows have landed
    __syncthreads();     // ... for every thread; plane xx - 1's products done
    // in flight over this plane, to raw slot xx & 1 (built)
    if (xx + 1 < xe) h.fetch_raw(xx + 2);
    cp_async_commit();
    h.build(xx + 1);
    __syncthreads();
    const bf16* pa0 = h.row(xx, a_dx[0], a_off[0]);
    const bf16* pa1 = h.row(xx, a_dx[1], a_off[1]);
#pragma unroll
    for (int i = 0; i < kFY / kSWarps; ++i) {
      const int r = warp + i * kSWarps;
      if (y0 + r >= Y) break;  // the Y tail: uniform over the warp
      unsigned af[2][4];
      ldmatrix_x4_trans(af[0], pa0 + r * Halo::kRowU * 8);
      ldmatrix_x4_trans(af[1], pa1 + r * Halo::kRowU * 8);
      float acc[kNT][4];
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[2 * np][e] = acc[2 * np + 1][e] = 0.f;
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          unsigned bf[4];
          ldmatrix_x4(bf, b_lane + 16 * np * kWRow + 16 * s);
          mma_bf16(acc[2 * np], af[s], bf[0], bf[1]);
          mma_bf16(acc[2 * np + 1], af[s], bf[2], bf[3]);
        }
      }
      // voxel g (c0, c1) and g + 8 (c2, c3) of the row, C contiguous
      // channels each: a quad stores a voxel's 16-byte pieces
      const int64_t base =
          ((b * X + xx) * Y + y0 + r) * static_cast<int64_t>(Z) + z0;
#pragma unroll
      for (int hv = 0; hv < 2; ++hv) {
        const int v = g + 8 * hv;
        const bool in = z0 + v < Z;  // the Z tail: nonzero, not stored
        if (kStats && in) {
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float a = acc[nt][2 * hv + e];
              sum[nt][e] += a;
              sq[nt][e] = fmaf(a, a, sq[nt][e]);
            }
          }
        }
        bf16* o = out + (base + v) * C;
#pragma unroll
        for (int q = 0; q < kNT / 4; ++q) {
          unsigned p[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            p[j] = pack_bf16(acc[4 * q + j][2 * hv],
                             acc[4 * q + j][2 * hv + 1]);
          }
          const uint4 piece = quad_transpose(p, t);
          if (in) __stcs(reinterpret_cast<uint4*>(o + 32 * q + 8 * t), piece);
        }
        if (kNT % 4 != 0) {  // C = 16, 48: the last two n-tiles
          constexpr int j0 = kNT - 2;
          const uint2 piece = pair_transpose(
              pack_bf16(acc[j0][2 * hv], acc[j0][2 * hv + 1]),
              pack_bf16(acc[j0 + 1][2 * hv], acc[j0 + 1][2 * hv + 1]), t);
          if (in) __stcs(reinterpret_cast<uint2*>(o + 8 * j0 + 4 * t), piece);
        }
      }
    }
  }
  cp_async_wait<0>();
  if (!kStats) return;

  // per channel: the eight lanes of one t add over g in a butterfly (the
  // same bits in all eight), then one thread a channel adds the warps in
  // order
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s = sum[nt][e], q = sq[nt][e];
#pragma unroll
      for (int m = 4; m < 32; m *= 2) {
        s += __shfl_xor_sync(0xffffffffu, s, m);
        q += __shfl_xor_sync(0xffffffffu, q, m);
      }
      if (g == 0) {
        red[warp][0][8 * nt + 2 * t + e] = s;
        red[warp][1][8 * nt + 2 * t + e] = q;
      }
    }
  }
  __syncthreads();
  const int64_t rows = gridDim.x;
  for (int i = tid; i < 2 * C; i += kSThreads) {
    const int set = i / C, c = i % C;
    float s = 0.f;
#pragma unroll
    for (int v = 0; v < kSWarps; ++v) s += red[v][set][c];
    partial[(set * rows + row) * C + c] = s;
  }
}

}  // namespace
}  // namespace transmf

namespace transmf {
namespace {

bool bad_volume(int B, int X, int Y, int Z, int C) {
  return B < 1 || X < 1 || Y < 1 || Z < 1 || C < 1 || C > 256;
}

bool bad_shape(int B, int X, int Y, int Z, int C, int planes) {
  return bad_volume(B, X, Y, Z, C) ||
         static_cast<int64_t>(B) * ceil_div(X, planes) > 65535;
}

dim3 brick_grid(int B, int X, int Y, int Z, int planes) {
  return dim3(static_cast<unsigned>(ceil_div(Z, kTZ)),
              static_cast<unsigned>(ceil_div(Y, kTY)),
              static_cast<unsigned>(B * ceil_div(X, planes)));
}

// How an "mma" kernel cuts a call: columns of tiles, nyt along y and nzt
// along z, each split into segs segments of seg_len planes along x; `rows`:
// its blocks, the rows of the partials.
struct StemMmaPlan {
  int nyt, nzt, segs, seg_len;
  int64_t rows;
};

// Columns of `rows` x 16 voxel tiles (K6 "mma" 16, K3 / K5 "mma" 32),
// split along x until the grid has kStemMmaBlocks blocks, as long as a
// segment keeps 8 planes.
StemMmaPlan stem_mma_plan(int B, int X, int Y, int Z, int rows) {
  StemMmaPlan p{};
  p.nyt = static_cast<int>(ceil_div(Y, rows));
  p.nzt = static_cast<int>(ceil_div(Z, kSZ));
  const int64_t columns = static_cast<int64_t>(B) * p.nyt * p.nzt;
  const int64_t want = ceil_div(kStemMmaBlocks, columns);
  const int64_t most = ceil_div(X, 8);
  p.seg_len = static_cast<int>(ceil_div(X, want < most ? want : most));
  p.segs = static_cast<int>(ceil_div(X, p.seg_len));
  p.rows = columns * p.segs;
  return p;
}

// The "mma" variants' refusals: bfloat16, C in 16, 32, 48, 64, the named
// tensors 16-byte aligned, a grid of at most 2^31 - 1 blocks.
bool bad_mma(int dtype, int C, const StemMmaPlan& p,
             std::initializer_list<const void*> aligned) {
  for (const void* ptr : aligned) {
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return true;
  }
  return dtype != kBFloat16 || C % 16 != 0 || C > 64 ||
         p.rows > 2147483647LL;
}

// f(std::integral_constant<int, C>{}) for C in 16, 32, 48, 64; f's status,
// or cudaErrorInvalidValue for another C.
template <typename F>
int by_channels(int C, F f) {
  switch (C) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 48: return f(std::integral_constant<int, 48>{});
    case 64: return f(std::integral_constant<int, 64>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int C>
int launch_stem_dw_mma(const void* x, const void* y, const void* gy,
                       const void* a, const void* b2, void* partial, int X,
                       int Y, int Z, const StemMmaPlan& p, cudaStream_t st) {
  using T = __nv_bfloat16;
  auto kernel = stem_dw_mma_kernel<C>;
  const size_t smem = stem_dw_mma_smem(C);
  // the limit counts the kernel's static a and b2 as well
  const cudaError_t status = allow_smem(kernel, smem + sizeof(float) * 2 * C);
  if (status != cudaSuccess) return static_cast<int>(status);
  kernel<<<static_cast<unsigned>(p.rows), kSThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const T*>(gy), static_cast<const float*>(a),
      static_cast<const float*>(b2), static_cast<float*>(partial), X, Y, Z,
      p.nyt, p.nzt, p.segs, p.seg_len);
  return static_cast<int>(cudaGetLastError());
}

template <int C, bool kStats>
int launch_stem_conv_mma(const void* x, const void* w, void* out,
                         void* partial, int X, int Y, int Z,
                         const StemMmaPlan& p, cudaStream_t st) {
  using T = __nv_bfloat16;
  stem_conv_mma_kernel<C, kStats>
      <<<static_cast<unsigned>(p.rows), kSThreads, 0, st>>>(
          static_cast<const T*>(x), static_cast<const T*>(w),
          static_cast<T*>(out), static_cast<float*>(partial), X, Y, Z, p.nyt,
          p.nzt, p.segs, p.seg_len);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace transmf

// K3. x: (B, X, Y, Z); w: (3, 3, 3, C); out: (B, X, Y, Z, C). variant 1
// ("mma") needs bfloat16, C in 16, 32, 48, 64 and a 16-byte aligned out;
// variant 0 ("direct") takes 1 <= C <= 256 with B * X <= 65535.
extern "C" int transmf_stem_conv(const void* x, const void* w, void* out,
                                 int B, int X, int Y, int Z, int C, int dtype,
                                 int variant, void* stream) {
  using namespace transmf;
  const auto st = static_cast<cudaStream_t>(stream);
  if (variant == 1) {
    const int invalid = static_cast<int>(cudaErrorInvalidValue);
    if (bad_volume(B, X, Y, Z, C)) return invalid;
    const StemMmaPlan p = stem_mma_plan(B, X, Y, Z, kFY);
    if (bad_mma(dtype, C, p, {out})) return invalid;
    return by_channels(C, [&](auto c) {
      return launch_stem_conv_mma<decltype(c)::value, false>(
          x, w, out, nullptr, X, Y, Z, p, st);
    });
  }
  if (variant != 0 || bad_shape(B, X, Y, Z, C, 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid = brick_grid(B, X, Y, Z, 1);
  const size_t smem = sizeof(float) * 27 * C;
  return dispatch(dtype, [&](auto tag) {
    using T = decltype(tag);
    stem_conv_kernel<T, false><<<grid, kThreads, smem, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<T*>(out), nullptr, X, Y, Z, C, 1);
  });
}

// Rows of K5's float32 partials (per set of sums) for a volume. variant: 0
// "direct" (its blocks, as for K6 "direct"), 1 "mma".
extern "C" int64_t transmf_stem_blocks(int B, int X, int Y, int Z,
                                       int variant) {
  using namespace transmf;
  if (variant == 1) {
    return bad_volume(B, X, Y, Z, 1) ? 0 : stem_mma_plan(B, X, Y, Z, kFY).rows;
  }
  const dim3 g = brick_grid(B, X, Y, Z, kXC);
  return static_cast<int64_t>(g.x) * g.y * g.z;
}

// Rows of K6's float32 partials for a call. variant: 0 "direct", 1 "mma".
extern "C" int64_t transmf_stem_dw_rows(int B, int X, int Y, int Z,
                                        int variant) {
  if (variant == 1) {
    return transmf::stem_mma_plan(B, X, Y, Z, transmf::kSY).rows;
  }
  return transmf_stem_blocks(B, X, Y, Z, 0);
}

// K5. As transmf_stem_conv, plus stats: float32 (2, C) [sum, sum of squares]
// of the float32 accumulators over B, X, Y, Z. partial: float32 scratch of
// 2 * transmf_stem_blocks(..., variant) * C.
extern "C" int transmf_stem_conv_stats(const void* x, const void* w, void* out,
                                       void* partial, void* stats, int B,
                                       int X, int Y, int Z, int C, int dtype,
                                       int variant, void* stream) {
  using namespace transmf;
  const auto st = static_cast<cudaStream_t>(stream);
  if (variant == 1) {
    const int invalid = static_cast<int>(cudaErrorInvalidValue);
    if (bad_volume(B, X, Y, Z, C)) return invalid;
    const StemMmaPlan p = stem_mma_plan(B, X, Y, Z, kFY);
    if (bad_mma(dtype, C, p, {out})) return invalid;
    const int status = by_channels(C, [&](auto c) {
      return launch_stem_conv_mma<decltype(c)::value, true>(
          x, w, out, partial, X, Y, Z, p, st);
    });
    if (status != cudaSuccess) return status;
    reduce_rows(static_cast<const float*>(partial), static_cast<float*>(stats),
                p.rows, C, 2, st);
    return static_cast<int>(cudaGetLastError());
  }
  if (variant != 0 || bad_shape(B, X, Y, Z, C, kXC)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid = brick_grid(B, X, Y, Z, kXC);
  const int64_t nblk = static_cast<int64_t>(grid.x) * grid.y * grid.z;
  const size_t smem = sizeof(float) * (27 + 2 * kItemsPerChannel) * C;
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
// 27 * C * transmf_stem_dw_rows(..., variant). variant 1 ("mma") needs
// bfloat16, C in 16, 32, 48, 64 and 16-byte aligned y and gy; variant 0
// ("direct") takes everything.
extern "C" int transmf_stem_dw(const void* x, const void* y, const void* gy,
                               const void* a, const void* b2, void* partial,
                               void* dw, int B, int X, int Y, int Z, int C,
                               int dtype, int variant, void* stream) {
  using namespace transmf;
  if (bad_shape(B, X, Y, Z, C, kXC) || variant < 0 || variant > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  if (variant == 1) {
    const StemMmaPlan p = stem_mma_plan(B, X, Y, Z, kSY);
    if (bad_mma(dtype, C, p, {y, gy})) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const int status = by_channels(C, [&](auto c) {
      return launch_stem_dw_mma<decltype(c)::value>(x, y, gy, a, b2, partial,
                                                    X, Y, Z, p, st);
    });
    if (status != cudaSuccess) return status;
    reduce_rows(static_cast<const float*>(partial), static_cast<float*>(dw),
                p.rows, 27 * C, 1, st);
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid = brick_grid(B, X, Y, Z, kXC);
  const int64_t nblk = static_cast<int64_t>(grid.x) * grid.y * grid.z;
  const int P = kThreads / C;
  const size_t smem = sizeof(float) * static_cast<size_t>(P) * 27 * C;
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
