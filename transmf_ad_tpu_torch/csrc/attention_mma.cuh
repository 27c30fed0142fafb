// The attention forward on the tensor cores, softmax(q k^T * scale) v for
// bfloat16 inputs with a head dim of 16, 32, 64 or 128: the "mma" variant of
// K2 (attention.cu, no logsumexp) and of K10 (flash_attention.cu, which also
// stores the float32 logsumexp of every query row for the backward kernels
// K11 and K12). One body, the store compiled in or out by kLse.
//
// FlashAttention-2 tiling on mma.sync.m16n8k16. A block of up to 4 warps
// owns 16 query rows a warp; the Q fragments live in registers. K and V
// stream through shared memory in chunks of 64 keys as bfloat16,
// double-buffered with cp.async, rows padded by 16 bytes so that ldmatrix
// reads them without bank conflicts; rows past M arrive as zeros and their
// scores are excluded by count (set to -inf before the row maximum), never
// masked to a large negative number. S = Q K^T accumulates in float32
// fragments; the online softmax works on the fragment layout (a row's
// maximum needs two shuffles within the quad, its sum is folded once at the
// end), with scale * log2(e) applied before the maximum and exp2f after it.
// P stays float32 for the row sum and enters the P V product as TWO bfloat16
// fragments, hi = bf16(p) and lo = bf16(p - hi): a single rounding of P
// (2^-9 relative on each of up to 2,048 terms) misses the one-ulp tolerance
// against the float32 plain version in about 1% of the outputs, the split
// leaves 2^-17. Q, K and V are bfloat16 already, so their products are exact
// in float32. One division and one rounding at the end. The logsumexp is
// kept in the log2 domain like the maximum and converted once:
// lse = (m2 + log2(l)) * ln(2), with m2 the row maximum of s * scale *
// log2(e), so that the backward's p = exp(s * scale - lse) holds in the
// natural log; rows past N store nothing. A call with fewer than 132 blocks
// of 4 warps takes 2 warps or 1 a block, so that the model's 150 tokens
// still spread over the card. The chunk copy, A-fragment load, ldmatrix lane
// offsets and warp count below are shared with the backward kernels
// (flash_bwd_mma.cuh).
#pragma once

#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace transmf {
namespace {

constexpr unsigned kMmaFull = 0xffffffffu;
constexpr int kChunk = 64;   // streamed rows (keys; K12: queries) a chunk
constexpr int kRowPad = 8;   // bfloat16 elements of padding per chunk row
constexpr int kMmaWarps = 4;  // at most; 16 query rows each
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// The A fragments (mma.cuh) of the 16 rows a warp owns of a row-major
// (rows, 16 KD) bfloat16 matrix: thread (g, t) passes r0 = the warp's first
// row + g and reads rows r0 and r0 + 8; rows at or past `rows` are zero.
template <int KD>
__device__ __forceinline__ void load_a_rows(unsigned (&a)[KD][4],
                                            const __nv_bfloat16* src, int r0,
                                            int rows, int t) {
  constexpr int D = 16 * KD;
  const int r1 = r0 + 8;
#pragma unroll
  for (int kc = 0; kc < KD; ++kc) {
    const int c = kc * 16 + 2 * t;
    const unsigned* p0 = reinterpret_cast<const unsigned*>(
        src + static_cast<int64_t>(r0) * D + c);
    const unsigned* p1 = reinterpret_cast<const unsigned*>(
        src + static_cast<int64_t>(r1) * D + c);
    a[kc][0] = r0 < rows ? p0[0] : 0u;
    a[kc][1] = r1 < rows ? p1[0] : 0u;
    a[kc][2] = r0 < rows ? p0[4] : 0u;
    a[kc][3] = r1 < rows ? p1[4] : 0u;
  }
}

// Starts the copy of rows row0 .. row0 + 63 of two row-major (rows, D)
// bfloat16 matrices a and b into buffer `buf` (of two) of their chunks a_s
// and b_s in shared memory, rows D + kRowPad elements apart; rows at or past
// `rows` arrive as zeros. The caller commits the group.
template <int D>
__device__ __forceinline__ void copy_chunk_pair(
    __nv_bfloat16* a_s, __nv_bfloat16* b_s, const __nv_bfloat16* a,
    const __nv_bfloat16* b, int buf, int row0, int rows, int tid,
    int nthreads) {
  constexpr int RS = D + kRowPad, CPR = D / 8;  // CPR: 16-byte pieces a row
  for (int i = tid; i < kChunk * CPR; i += nthreads) {
    const int r = i / CPR, c = i % CPR;
    const bool real = row0 + r < rows;
    const int64_t off = static_cast<int64_t>(real ? row0 + r : 0) * D + c * 8;
    const int dst = (buf * kChunk + r) * RS + c * 8;
    cp_async16(a_s + dst, a + off, real);
    cp_async16(b_s + dst, b + off, real);
  }
}

// Offsets (in elements) of the row a lane hands to ldmatrix.x4 for the B
// fragments of two neighbouring n-tiles (mma.cuh), in a chunk whose rows are
// RS elements apart: stored [n][k], read without .trans (lane_nk), or stored
// [k][n], read with it (lane_kn).
__device__ __forceinline__ int lane_nk(int lane, int RS) {
  return ((lane & 7) + (lane >> 4) * 8) * RS + ((lane >> 3) & 1) * 8;
}
__device__ __forceinline__ int lane_kn(int lane, int RS) {
  return ((lane & 7) + ((lane >> 3) & 1) * 8) * RS + (lane >> 4) * 8;
}

// KD = D / 16. blockDim.x / 32 warps, 16 query rows each. kLse: also the
// natural-log logsumexp of every query row into lse, (BH, N) float32.
template <int KD, bool kLse>
__global__ void __launch_bounds__(kMmaWarps * 32)
    attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                         int N, int M, int tiles, float scale_log2e) {
  constexpr int D = 16 * KD;
  constexpr int RS = D + kRowPad;  // row stride, an odd multiple of 16 bytes
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // K and V, [2][64][RS] each
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + 2 * kChunk * RS;

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x / tiles;
  const int row0 = (blockIdx.x % tiles) * (nthreads / 2) + warp * 16;
  q += static_cast<int64_t>(bh) * N * D;
  o += static_cast<int64_t>(bh) * N * D;
  k += static_cast<int64_t>(bh) * M * D;
  v += static_cast<int64_t>(bh) * M * D;
  const int r0 = row0 + g, r1 = row0 + g + 8;

  auto load_chunk = [&](int buf, int key0) {
    copy_chunk_pair<D>(ks, vs, k, v, buf, key0, M, tid, nthreads);
    cp_async_commit();
  };
  load_chunk(0, 0);

  unsigned qa[KD][4];
  load_a_rows<KD>(qa, q, r0, N, t);

  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float acc[2 * KD][4];
#pragma unroll
  for (int j = 0; j < 2 * KD; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }
  const bool active = row0 < N;  // the same for the whole warp
  // lane offsets of the ldmatrix rows: K without .trans, V with it
  const int k_lane = lane_nk(lane, RS), v_lane = lane_kn(lane, RS);

  const int chunks = (M + kChunk - 1) / kChunk;
  for (int ch = 0; ch < chunks; ++ch) {
    if (ch + 1 < chunks) {
      load_chunk((ch + 1) & 1, (ch + 1) * kChunk);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // every thread's pieces of chunk ch have landed
    if (active) {
      const __nv_bfloat16* kb = ks + (ch & 1) * kChunk * RS;
      const __nv_bfloat16* vb = vs + (ch & 1) * kChunk * RS;
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      }
#pragma unroll
      for (int kc = 0; kc < KD; ++kc) {
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          unsigned b[4];
          ldmatrix_x4(b, kb + jp * 16 * RS + kc * 16 + k_lane);
          mma_bf16(s[2 * jp], qa[kc], b[0], b[1]);
          mma_bf16(s[2 * jp + 1], qa[kc], b[2], b[3]);
        }
      }
      const int nk = min(kChunk, M - ch * kChunk);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= scale_log2e;
      }
      if (nk < kChunk) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (j * 8 + 2 * t + (e & 1) >= nk) s[j][e] = -INFINITY;
          }
        }
      }
      float mx0 = s[0][0], mx1 = s[0][2];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
        mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(kMmaFull, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(kMmaFull, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(kMmaFull, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(kMmaFull, mx1, 2));
      // every chunk holds at least one real key, so the new maxima are finite
      const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
      const float alpha0 = exp2f(m0 - n0), alpha1 = exp2f(m1 - n1);
      m0 = n0;
      m1 = n1;
      l0 *= alpha0;
      l1 *= alpha1;
#pragma unroll
      for (int j = 0; j < 2 * KD; ++j) {
        acc[j][0] *= alpha0;
        acc[j][1] *= alpha0;
        acc[j][2] *= alpha1;
        acc[j][3] *= alpha1;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j][0] = exp2f(s[j][0] - m0);
        s[j][1] = exp2f(s[j][1] - m0);
        s[j][2] = exp2f(s[j][2] - m1);
        s[j][3] = exp2f(s[j][3] - m1);
        l0 += s[j][0] + s[j][1];
        l1 += s[j][2] + s[j][3];
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // 16 keys: s[2 kk] and s[2 kk + 1]
        unsigned hi[4], lo[4];
        split_bf16(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
        split_bf16(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
        split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
        split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
        for (int dp = 0; dp < KD; ++dp) {
          unsigned b[4];
          ldmatrix_x4_trans(b, vb + kk * 16 * RS + dp * 16 + v_lane);
          mma_bf16(acc[2 * dp], hi, b[0], b[1]);
          mma_bf16(acc[2 * dp + 1], hi, b[2], b[3]);
          mma_bf16(acc[2 * dp], lo, b[0], b[1]);
          mma_bf16(acc[2 * dp + 1], lo, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // chunk ch is read; the next load may overwrite it
  }

  if (!active) return;
  l0 += __shfl_xor_sync(kMmaFull, l0, 1);
  l0 += __shfl_xor_sync(kMmaFull, l0, 2);
  l1 += __shfl_xor_sync(kMmaFull, l1, 1);
  l1 += __shfl_xor_sync(kMmaFull, l1, 2);
  if (kLse && t == 0) {
    // m is the maximum of s * scale * log2(e): back to the natural log
    float* row_lse = lse + static_cast<int64_t>(bh) * N;
    if (r0 < N) row_lse[r0] = (m0 + log2f(l0)) * kLn2;
    if (r1 < N) row_lse[r1] = (m1 + log2f(l1)) * kLn2;
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
  for (int j = 0; j < 2 * KD; ++j) {
    const int c = j * 8 + 2 * t;
    if (r0 < N) {
      *reinterpret_cast<unsigned*>(o + static_cast<int64_t>(r0) * D + c) =
          pack_bf16(acc[j][0] * inv0, acc[j][1] * inv0);
    }
    if (r1 < N) {
      *reinterpret_cast<unsigned*>(o + static_cast<int64_t>(r1) * D + c) =
          pack_bf16(acc[j][2] * inv1, acc[j][3] * inv1);
    }
  }
}

// Warps a block for `rows` rows of each of BH (batch, head) pairs, 16 a
// warp: the most (up to 4) that still give the card's 132 SMs a block each.
inline int mma_warps(int BH, int rows) {
  int warps = kMmaWarps;
  while (warps > 1 && BH * ceil_div(rows, 16 * warps) < 132) warps /= 2;
  return warps;
}

template <int KD, bool kLse>
int launch_mma_width(const void* q, const void* k, const void* v, void* o,
                     void* lse, int BH, int N, int M, float scale,
                     cudaStream_t stream) {
  const int warps = mma_warps(BH, N);
  const int tiles = static_cast<int>(ceil_div(N, 16 * warps));
  const int64_t blocks = static_cast<int64_t>(BH) * tiles;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      sizeof(__nv_bfloat16) * 4 * kChunk * (16 * KD + kRowPad);
  auto kernel = attention_mma_kernel<KD, kLse>;
  const cudaError_t st = allow_smem(kernel, smem);
  if (st != cudaSuccess) return static_cast<int>(st);
  using B = __nv_bfloat16;
  kernel<<<static_cast<unsigned>(blocks), warps * 32, smem, stream>>>(
      static_cast<const B*>(q), static_cast<const B*>(k),
      static_cast<const B*>(v), static_cast<B*>(o), static_cast<float*>(lse),
      N, M, tiles, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Launches the "mma" forward: q (BH, N, D), k and v (BH, M, D), o (BH, N,
// D), all bfloat16 and 16-byte aligned, D in {16, 32, 64, 128}, N, M >= 1;
// with kLse also lse, (BH, N) float32. Refuses anything else. Returns the
// CUDA status.
template <bool kLse>
int launch_attention_mma(const void* q, const void* k, const void* v, void* o,
                         void* lse, int BH, int N, int M, int D, float scale,
                         int dtype, void* stream) {
  if (dtype != kBFloat16 || M < 1 || N < 1 || BH < 1 || !aligned16(q) ||
      !aligned16(k) || !aligned16(v) || !aligned16(o)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const auto width = [&](auto kd) {
    return launch_mma_width<decltype(kd)::value, kLse>(q, k, v, o, lse, BH, N,
                                                       M, scale, st);
  };
  switch (D) {
    case 16: return width(std::integral_constant<int, 1>{});
    case 32: return width(std::integral_constant<int, 2>{});
    case 64: return width(std::integral_constant<int, 4>{});
    case 128: return width(std::integral_constant<int, 8>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace transmf
