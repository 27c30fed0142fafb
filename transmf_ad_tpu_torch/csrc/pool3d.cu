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
// Two variants of each kernel, chosen in the wrapper by dtype and C alone
// (ops/pool3d.py::variant):
//
// "vec", wherever a channel row is a whole number of 16-byte pieces (bf16
// with C % 8 == 0, float32 with C % 4 == 0: the models' widths): a thread
// owns one 16-byte group of V channels (8 bf16, 4 float32) at one pooled z.
// K4 "vec" gives each thread one output vector: 8 window reads of 16 bytes,
// the affine as float4s, one 16-byte store; the block is one pooled row's
// lanes (zp, group), so the index decode is two 32-bit divisions a thread.
// K7 "vec" keeps the lanes of a thread fixed for the whole kernel: it holds
// their scale and shift and their four float32 sums in registers across
// every row its block walks, reads y once as 16-byte pieces, keeps the
// window in registers for the second pass and writes dy as 16-byte pieces.
//
// "direct", every other shape: one thread per output element (K4) or per
// pooled lane (K7), 2- or 4-byte accesses.
//
// Both compute pre = y*s + b with explicitly rounded float32 multiply and
// add (no FMA contraction), so they agree bit for bit with the unfused
// float32 reference and with each other; the activation is rounded to the
// storage type BEFORE the max or the sum, as in the TPU kernels. The mean
// sums the 8 rounded values in float32, in window order.
#include <cstdint>
#include <initializer_list>

#include "common.cuh"
#include "mma.cuh"

namespace transmf {
namespace {

constexpr int kThreads = 256;
constexpr int kBwdThreads = 512;
// "vec": the most lane threads a block holds; a pooled row with more lanes
// is cut into slices, one block each (gridDim.y)
constexpr int kVecThreads = 384;
// K7 "vec": 16-byte vectors a thread reads per row (8 window, g, p), and
// the stages of its ring in shared memory
constexpr int kVecItems = 10;
constexpr int kVecStages = 3;

// A 16-byte vector of storage is handled as 4 words of 32 bits. Channel h of
// a word: float32 is one channel a word, bfloat16 two (the lower address in
// the low half).
template <typename T>
__device__ __forceinline__ float word_value(unsigned w, int h);
template <>
__device__ __forceinline__ float word_value<float>(unsigned w, int) {
  return __uint_as_float(w);
}
template <>
__device__ __forceinline__ float word_value<__nv_bfloat16>(unsigned w, int h) {
  return __uint_as_float(h ? w & 0xffff0000u : w << 16);
}

// a word's channels: one float32, or two rounded to bfloat16 (nearest even)
__device__ __forceinline__ unsigned to_word(const float (&f)[1]) {
  return __float_as_uint(f[0]);
}
__device__ __forceinline__ unsigned to_word(const float (&f)[2]) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(f[0], f[1]);
  return *reinterpret_cast<const unsigned*>(&h);
}

// x rounded to the storage type T and back
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// V consecutive float32 (V = 4 or 8, 16-byte aligned) as float4 loads
template <int V>
__device__ __forceinline__ void load_floats(const float* p, float (&f)[V]) {
#pragma unroll
  for (int i = 0; i < V / 4; ++i) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p) + i);
    f[4 * i] = q.x;
    f[4 * i + 1] = q.y;
    f[4 * i + 2] = q.z;
    f[4 * i + 3] = q.w;
  }
}

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

// K4 "vec". Block (row, slice): row = (b, xp, yp) of the pooled grid,
// thread = lane (zp, group) of that row, lanes = Zp * C / V. The thread reads
// its 8 window vectors (2 raw z x 4 raw rows) and the affine of raw z 2zp
// and 2zp + 1 (the same (C,) vector twice for channels), and stores one
// vector of the pooled row. Window order and arithmetic are "direct"'s.
template <typename T, bool kMean, bool kLanes>
__global__ void __launch_bounds__(kVecThreads)
    affine_act_pool_vec_kernel(const T* __restrict__ y,
                               const float* __restrict__ scale,
                               const float* __restrict__ shift,
                               T* __restrict__ out, int X, int Y, int Z, int C,
                               float slope) {
  constexpr int V = 16 / sizeof(T);
  constexpr int PER = V / 4;  // channels in a 32-bit word
  const int G = C / V, Yp = Y / 2, Zp = Z / 2;
  const int lanes = Zp * G;
  const int lane = blockIdx.y * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const int zp = lane / G, grp = lane - zp * G;
  const int row = blockIdx.x;  // b * Xp * Yp + xp * Yp + yp
  const int yp = row % Yp, bx = row / Yp;  // bx = b * Xp + xp
  const int xp = bx % (X / 2), b = bx / (X / 2);

  float s[2][V], sh[2][V];
  const int a0 = (kLanes ? 2 * zp * C : 0) + grp * V;
#pragma unroll
  for (int dz = 0; dz < 2; ++dz) {
    load_floats<V>(scale + a0 + (kLanes ? dz * C : 0), s[dz]);
    load_floats<V>(shift + a0 + (kLanes ? dz * C : 0), sh[dz]);
  }
  // 16-byte vectors: a raw row holds Z * G of them
  const uint4* yv = reinterpret_cast<const uint4*>(y);
  const int64_t zg = static_cast<int64_t>(Z) * G;
  const int64_t raw0 = (static_cast<int64_t>(b) * X + 2 * xp) * Y + 2 * yp;
  unsigned win[8][4];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int dx = k >> 2, dyy = (k >> 1) & 1, dz = k & 1;
    const uint4 q =
        __ldcs(yv + (raw0 + dx * Y + dyy) * zg + (2 * zp + dz) * G + grp);
    win[k][0] = q.x;
    win[k][1] = q.y;
    win[k][2] = q.z;
    win[k][3] = q.w;
  }
  unsigned res[4];
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    float pooled[PER];
#pragma unroll
    for (int h = 0; h < PER; ++h) {
      const int j = w * PER + h;
      float best = -INFINITY, sum = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int dz = k & 1;
        const float v = word_value<T>(win[k][w], h);
        const float pre = __fadd_rn(__fmul_rn(v, s[dz][j]), sh[dz][j]);
        const float act = pre >= 0.f ? pre : __fmul_rn(slope, pre);
        const float rounded = round_to<T>(act);
        if (kMean) {
          sum += rounded;
        } else {
          best = fmaxf(best, rounded);
        }
      }
      pooled[h] = kMean ? sum * 0.125f : best;
    }
    res[w] = to_word(pooled);
  }
  reinterpret_cast<uint4*>(out)[static_cast<int64_t>(row) * lanes + lane] =
      make_uint4(res[0], res[1], res[2], res[3]);
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

// K7 "vec". Block (i, slice) walks the rows r = i, i + gridDim.x, ... of
// the extended pooled grid (B, ceil(X/2), ceil(Y/2)); its thread owns the
// lane (zp, group) = slice * blockDim.x + threadIdx.x for the whole kernel,
// i.e. raw z 2zp and 2zp + 1 of V channels. It keeps their scale and shift
// and the four sums (dpre*y and dpre for dz = 0, 1) in registers; per row
// it reads p, g and its 8 window vectors once, counts the ties, then
// recomputes each window value's pre from the vectors in registers and
// writes dy as 16-byte vectors. The reads of the block's next two rows are
// in flight while it computes this one: each thread copies its own 10 vectors
// by cp.async into its slots of a three-stage ring in shared memory (no
// barrier: no thread reads another's slots). Rows on an odd x or y tail,
// and raw z = Z-1 on an odd z tail, get 16-byte zeros. Sum order: per
// thread over its rows, within a row over (dx, dy); then the block's
// partial row (zero on the odd z tail) and reduce_rows over the blocks in
// order.
template <typename T, bool kMean, bool kRoundGi, bool kLanes>
__global__ void __launch_bounds__(kVecThreads)
    affine_act_pool_bwd_vec_kernel(const T* __restrict__ y,
                                   const float* __restrict__ scale,
                                   const float* __restrict__ shift,
                                   const T* __restrict__ p,
                                   const T* __restrict__ g, T* __restrict__ dy,
                                   float* __restrict__ partial, int B, int X,
                                   int Y, int Z, int C, float slope) {
  constexpr int V = 16 / sizeof(T);
  constexpr int PER = V / 4;  // channels in a 32-bit word
  const int G = C / V;
  const int Xp = X / 2, Yp = Y / 2, Zp = Z / 2;
  const int Xq = (X + 1) / 2, Yq = (Y + 1) / 2;
  const int lanes = Zp * G;
  const int lane = blockIdx.y * blockDim.x + threadIdx.x;
  const bool active = lane < lanes;
  const int zp = active ? lane / G : 0;
  const int grp = active ? lane - zp * G : 0;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const uint4* yv = reinterpret_cast<const uint4*>(y);
  const uint4* pv = reinterpret_cast<const uint4*>(p);
  const uint4* gv = reinterpret_cast<const uint4*>(g);
  uint4* dyv = reinterpret_cast<uint4*>(dy);
  const int64_t zg = static_cast<int64_t>(Z) * G;  // vectors in a raw row

  float s[2][V], sh[2][V], ds[2][V], db[2][V];
  const int a0 = (kLanes ? 2 * zp * C : 0) + grp * V;
#pragma unroll
  for (int dz = 0; dz < 2; ++dz) {
    load_floats<V>(scale + a0 + (kLanes ? dz * C : 0), s[dz]);
    load_floats<V>(shift + a0 + (kLanes ? dz * C : 0), sh[dz]);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      ds[dz][j] = 0.f;
      db[dz][j] = 0.f;
    }
  }

  // ring[(stage * kVecItems + item) * blockDim.x + threadIdx.x]: items 0-7
  // the window (k = dx * 4 + dy * 2 + dz), 8 g, 9 p
  extern __shared__ uint4 ring[];
  const int64_t rows = static_cast<int64_t>(B) * Xq * Yq;
  auto slot = [&](int stage, int item) -> uint4* {
    return ring + (stage * kVecItems + item) * blockDim.x + threadIdx.x;
  };
  // start the copies of row r (if it is a pooled row of this grid) into
  // `stage`, then close the group (an empty one otherwise)
  auto fetch = [&](int64_t r, int stage) {
    if (active && r < rows) {
      const int yq = static_cast<int>(r % Yq);
      const int64_t bx = r / Yq;
      const int xq = static_cast<int>(bx % Xq);
      const int64_t b = bx / Xq;
      if (xq < Xp && yq < Yp) {
        const int64_t raw0 = (b * X + 2 * xq) * Y + 2 * yq;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int dx = k >> 2, dyy = (k >> 1) & 1, dz = k & 1;
          cp_async16(slot(stage, k),
                     yv + (raw0 + dx * Y + dyy) * zg + (2 * zp + dz) * G + grp,
                     true);
        }
        const int64_t pi = ((b * Xp + xq) * Yp + yq) * lanes + lane;
        cp_async16(slot(stage, 8), gv + pi, true);
        if (!kMean) cp_async16(slot(stage, 9), pv + pi, true);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i + 1 < kVecStages; ++i) {
    fetch(blockIdx.x + static_cast<int64_t>(i) * gridDim.x, i);
  }
  int stage = 0;
  for (int64_t r = blockIdx.x; r < rows;
       r += gridDim.x, stage = (stage + 1) % kVecStages) {
    fetch(r + static_cast<int64_t>(kVecStages - 1) * gridDim.x,
          (stage + kVecStages - 1) % kVecStages);
    const int yq = static_cast<int>(r % Yq);
    const int64_t bx = r / Yq;  // b * Xq + xq
    const int xq = static_cast<int>(bx % Xq);
    const int64_t b = bx / Xq;
    const int64_t raw0 = (b * X + 2 * xq) * Y + 2 * yq;
    if (xq >= Xp || yq >= Yp) {  // odd x or y tail: zero gradient
      for (int k = 0; k < 4; ++k) {
        const int dx = k >> 1, dyy = k & 1;
        if (2 * xq + dx >= X || 2 * yq + dyy >= Y || !active) continue;
        uint4* o = dyv + (raw0 + dx * Y + dyy) * zg;
        for (int64_t v = lane; v < zg; v += lanes) __stcs(o + v, zero);
      }
      continue;
    }
    if (active) {
      // this row's group; the next rows' stay in flight
      cp_async_wait<kVecStages - 1>();
      const uint4 gq = *slot(stage, 8);
      const uint4 pq = kMean ? zero : *slot(stage, 9);
      const unsigned gw[4] = {gq.x, gq.y, gq.z, gq.w};
      const unsigned pw[4] = {pq.x, pq.y, pq.z, pq.w};
      unsigned win[8][4];  // the window's 8 vectors; dy replaces them
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const uint4 q = *slot(stage, k);
        win[k][0] = q.x;
        win[k][1] = q.y;
        win[k][2] = q.z;
        win[k][3] = q.w;
      }
      // one 32-bit word (PER channels) at a time, both passes for each of
      // its channels, so that only one channel's 8 pre values are live
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        float out[8][PER];
#pragma unroll
        for (int h = 0; h < PER; ++h) {
          const int j = w * PER + h;
          float v[8], pre[8];
          int cnt = 0;
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const int dz = k & 1;
            v[k] = word_value<T>(win[k][w], h);
            pre[k] = __fadd_rn(__fmul_rn(v[k], s[dz][j]), sh[dz][j]);
            if (!kMean) {
              const float act = pre[k] >= 0.f ? pre[k]
                                              : __fmul_rn(slope, pre[k]);
              cnt += round_to<T>(act) == word_value<T>(pw[w], h) ? 1 : 0;
            }
          }
          const float gf = word_value<T>(gw[w], h);
          float gi;
          if (kMean) {
            gi = round_to<T>(gf * 0.125f);
          } else {
            gi = gf / fmaxf(static_cast<float>(cnt), 1.f);
            if (kRoundGi) gi = round_to<T>(gi);
          }
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const int dz = k & 1;
            bool eq = true;
            if (!kMean) {
              const float act = pre[k] >= 0.f ? pre[k]
                                              : __fmul_rn(slope, pre[k]);
              eq = round_to<T>(act) == word_value<T>(pw[w], h);
            }
            const float dzv = eq ? gi : 0.f;
            const float dpre = pre[k] >= 0.f ? dzv : __fmul_rn(dzv, slope);
            out[k][h] = __fmul_rn(dpre, s[dz][j]);
            ds[dz][j] = fmaf(dpre, v[k], ds[dz][j]);
            db[dz][j] += dpre;
          }
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) win[k][w] = to_word(out[k]);
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int dx = k >> 2, dyy = (k >> 1) & 1, dz = k & 1;
        __stcs(dyv + (raw0 + dx * Y + dyy) * zg + (2 * zp + dz) * G + grp,
               make_uint4(win[k][0], win[k][1], win[k][2], win[k][3]));
      }
    }
    if (Z > 2 * Zp && active) {  // odd z tail of the four raw rows
      for (int v = lane; v < 4 * G; v += lanes) {
        const int k = v / G, c = v - k * G;
        __stcs(dyv + (raw0 + (k >> 1) * Y + (k & 1)) * zg + (Z - 1) * G + c,
               zero);
      }
    }
  }
  // the block's partial row: columns (2zp + dz) * C + group * V + j
  const int zc = Z * C;
  float* part = partial + static_cast<int64_t>(blockIdx.x) * zc;
  const int64_t set = static_cast<int64_t>(gridDim.x) * zc;
  if (active) {
#pragma unroll
    for (int dz = 0; dz < 2; ++dz) {
      const int col = (2 * zp + dz) * C + grp * V;
      float4* ps = reinterpret_cast<float4*>(part + col);
      float4* pb = reinterpret_cast<float4*>(part + set + col);
#pragma unroll
      for (int i = 0; i < V / 4; ++i) {
        ps[i] = make_float4(ds[dz][4 * i], ds[dz][4 * i + 1],
                            ds[dz][4 * i + 2], ds[dz][4 * i + 3]);
        pb[i] = make_float4(db[dz][4 * i], db[dz][4 * i + 1],
                            db[dz][4 * i + 2], db[dz][4 * i + 3]);
      }
    }
    if (Z > 2 * Zp) {  // the odd z tail's columns
      for (int c = lane * V; c < C; c += lanes * V) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          part[(Z - 1) * C + c + j] = 0.f;
          part[set + (Z - 1) * C + c + j] = 0.f;
        }
      }
    }
  }
}

}  // namespace
}  // namespace transmf

namespace {

// "vec" takes 16-byte groups of channels: C a multiple of 16 / sizeof(T),
// every pointer 16-byte aligned, `threads` lane threads a block (a multiple
// of 32, at most kVecThreads); returns the lane slices of a pooled row, or
// 0 if the launch is refused
inline int vec_slices(int dtype, int Z, int C, int threads,
                      std::initializer_list<const void*> ptrs) {
  using namespace transmf;
  const int v = dtype == kBFloat16 ? 8 : 4;
  if (C % v != 0 || threads < 32 || threads > kVecThreads || threads % 32) {
    return 0;
  }
  for (const void* q : ptrs) {
    if (reinterpret_cast<uintptr_t>(q) % 16 != 0) return 0;
  }
  const int64_t slices = ceil_div(static_cast<int64_t>(Z / 2) * (C / v),
                                  threads);
  return slices <= 65535 ? static_cast<int>(slices) : 0;
}

}  // namespace

// y: (B, X, Y, Z, C); scale, shift: float32, (C,) when zstride == 0 or (Z*C,)
// when zstride == C; out: (B, X//2, Y//2, Z//2, C). mode 0 = max, 1 = mean.
// variant 0 = "direct", 1 = "vec" with `threads` lane threads a block (see
// vec_slices; ignored by "direct").
extern "C" int transmf_affine_act_pool(const void* y, const void* scale,
                                       const void* shift, void* out, int B,
                                       int X, int Y, int Z, int C, int zstride,
                                       float slope, int mode, int dtype,
                                       int variant, int threads,
                                       void* stream) {
  using namespace transmf;
  const int Xp = X / 2, Yp = Y / 2, Zp = Z / 2;
  if (B < 1 || Xp < 1 || Yp < 1 || Zp < 1 || C < 1 || (mode != 0 && mode != 1) ||
      (zstride != 0 && zstride != C) || (variant != 0 && variant != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t total = static_cast<int64_t>(B) * Xp * Yp * Zp * C;
  const auto st = static_cast<cudaStream_t>(stream);
  if (variant == 1) {
    const int slices = vec_slices(dtype, Z, C, threads, {y, scale, shift, out});
    const int64_t rows = static_cast<int64_t>(B) * Xp * Yp;
    if (slices == 0 || rows > 2147483647) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const dim3 grid(static_cast<unsigned>(rows), static_cast<unsigned>(slices));
    return dispatch(dtype, [&](auto tag) {
      using T = decltype(tag);
      const auto* yy = static_cast<const T*>(y);
      const auto* s = static_cast<const float*>(scale);
      const auto* sh = static_cast<const float*>(shift);
      auto* o = static_cast<T*>(out);
      auto kernel = mode == 1 ? (zstride ? affine_act_pool_vec_kernel<T, true, true>
                                         : affine_act_pool_vec_kernel<T, true, false>)
                              : (zstride ? affine_act_pool_vec_kernel<T, false, true>
                                         : affine_act_pool_vec_kernel<T, false, false>);
      kernel<<<grid, threads, 0, st>>>(yy, s, sh, o, X, Y, Z, C, slope);
    });
  }
  const int blocks = static_cast<int>(
      ceil_div(total, kThreads) < 132 * 64 ? ceil_div(total, kThreads) : 132 * 64);
  return dispatch(dtype, [&](auto tag) {
    using T = decltype(tag);
    const auto* yy = static_cast<const T*>(y);
    const auto* s = static_cast<const float*>(scale);
    const auto* sh = static_cast<const float*>(shift);
    auto* o = static_cast<T*>(out);
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
// zstride == 0. partial: float32 scratch of 2 * grid * Z * C, grid blocks
// ("vec": grid blocks of rows, each with ceil(lanes / threads) slices).
// mode 0 = max (ties split equally; round_gi rounds g/count to the storage
// type, as the TPU lane kernel does), 1 = mean. variant as for
// transmf_affine_act_pool.
extern "C" int transmf_affine_act_pool_bwd(
    const void* y, const void* scale, const void* shift, const void* p,
    const void* g, void* dy, void* partial, void* dsb, int B, int X, int Y,
    int Z, int C, int zstride, float slope, int mode, int round_gi, int grid,
    int dtype, int variant, int threads, void* stream) {
  using namespace transmf;
  if (B < 1 || X < 2 || Y < 2 || Z < 2 || C < 1 || grid < 1 ||
      (mode != 0 && mode != 1) || (zstride != 0 && zstride != C) ||
      (variant != 0 && variant != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  int slices = 0;
  const size_t smem = sizeof(float) * 2 * static_cast<size_t>(Z) * C;
  if (variant == 1) {
    slices = vec_slices(dtype, Z, C, threads,
                        {y, scale, shift, p, g, dy, partial});
    if (slices == 0) return static_cast<int>(cudaErrorInvalidValue);
  } else if (smem > 227 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dispatch(dtype, [&](auto tag) {
    using T = decltype(tag);
    const auto* yy = static_cast<const T*>(y);
    const auto* s = static_cast<const float*>(scale);
    const auto* sh = static_cast<const float*>(shift);
    const auto* pp = static_cast<const T*>(p);
    const auto* gg = static_cast<const T*>(g);
    auto* d = static_cast<T*>(dy);
    auto* part = static_cast<float*>(partial);
    if (variant == 1) {
      const bool lanes = zstride != 0;
      auto kernel =
          mode == 1 ? (lanes ? affine_act_pool_bwd_vec_kernel<T, true, false, true>
                             : affine_act_pool_bwd_vec_kernel<T, true, false, false>)
          : round_gi ? (lanes ? affine_act_pool_bwd_vec_kernel<T, false, true, true>
                              : affine_act_pool_bwd_vec_kernel<T, false, true, false>)
                     : (lanes ? affine_act_pool_bwd_vec_kernel<T, false, false, true>
                              : affine_act_pool_bwd_vec_kernel<T, false, false, false>);
      const size_t ring = sizeof(uint4) * kVecStages * kVecItems * threads;
      if (allow_smem(kernel, ring) != cudaSuccess) return;
      kernel<<<dim3(grid, slices), threads, ring, st>>>(
          yy, s, sh, pp, gg, d, part, B, X, Y, Z, C, slope);
    } else {
      auto kernel = mode == 1 ? affine_act_pool_bwd_kernel<T, true, false>
                    : round_gi ? affine_act_pool_bwd_kernel<T, false, true>
                               : affine_act_pool_bwd_kernel<T, false, false>;
      if (allow_smem(kernel, smem) != cudaSuccess) return;
      kernel<<<grid, kBwdThreads, smem, st>>>(yy, s, sh, pp, gg, d, part, B, X,
                                             Y, Z, C, zstride, slope);
    }
    // lanes: rows = blocks, columns = Z*C; channels: rows = (block, z)
    if (zstride != 0) {
      reduce_rows(part, static_cast<float*>(dsb), grid, Z * C, 2, st);
    } else {
      reduce_rows(part, static_cast<float*>(dsb),
                  static_cast<int64_t>(grid) * Z, C, 2, st);
    }
  });
}
