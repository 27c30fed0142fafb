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
// still spread over the card.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace transmf {
namespace {

constexpr unsigned kMmaFull = 0xffffffffu;
constexpr int kChunk = 64;   // keys per shared-memory chunk
constexpr int kRowPad = 8;   // bfloat16 elements of padding per K / V row
constexpr int kMmaWarps = 4;  // at most; 16 query rows each
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// hi = bf16(a, b), lo = bf16(a - hi.a, b - hi.b), packed.
__device__ __forceinline__ void split_bf16(float a, float b, unsigned& hi,
                                           unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = pack_bf16(a - hf.x, b - hf.y);
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
  constexpr int CPR = D / 8;       // 16-byte pieces per row
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
    for (int i = tid; i < kChunk * CPR; i += nthreads) {
      const int r = i / CPR, c = i % CPR;
      const bool real = key0 + r < M;
      const int64_t off = static_cast<int64_t>(real ? key0 + r : 0) * D + c * 8;
      const int dst = (buf * kChunk + r) * RS + c * 8;
      cp_async16(ks + dst, k + off, real);
      cp_async16(vs + dst, v + off, real);
    }
    cp_async_commit();
  };
  load_chunk(0, 0);

  unsigned qa[KD][4];
#pragma unroll
  for (int kc = 0; kc < KD; ++kc) {
    const int c = kc * 16 + 2 * t;
    const unsigned* p0 = reinterpret_cast<const unsigned*>(
        q + static_cast<int64_t>(r0) * D + c);
    const unsigned* p1 = reinterpret_cast<const unsigned*>(
        q + static_cast<int64_t>(r1) * D + c);
    qa[kc][0] = r0 < N ? p0[0] : 0u;
    qa[kc][1] = r1 < N ? p1[0] : 0u;
    qa[kc][2] = r0 < N ? p0[4] : 0u;
    qa[kc][3] = r1 < N ? p1[4] : 0u;
  }

  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float acc[2 * KD][4];
#pragma unroll
  for (int j = 0; j < 2 * KD; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }
  const bool active = row0 < N;  // the same for the whole warp
  // lane offsets of the ldmatrix rows: K without .trans, V with it
  const int k_lane =
      ((lane & 7) + (lane >> 4) * 8) * RS + ((lane >> 3) & 1) * 8;
  const int v_lane =
      ((lane & 7) + ((lane >> 3) & 1) * 8) * RS + (lane >> 4) * 8;

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

template <int KD, bool kLse>
int launch_mma_width(const void* q, const void* k, const void* v, void* o,
                     void* lse, int BH, int N, int M, float scale,
                     cudaStream_t stream) {
  // the most warps a block (up to 4) that still give the card's 132 SMs a
  // block each
  int warps = kMmaWarps;
  while (warps > 1 && BH * ceil_div(N, 16 * warps) < 132) warps /= 2;
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
