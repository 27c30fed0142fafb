// The flash backward on the tensor cores for bfloat16 inputs with a head dim
// of 16, 32 or 64: the "mma" variants of K11 (dq) and K12 (dk, dv), included
// by flash_attention.cu, whose note gives the arithmetic.
//
// FlashAttention-2's backward tiling on mma.sync.m16n8k16 with float32
// accumulators, as two kernels without atomics (each output element is
// written once, by one thread). Both recompute the probabilities from the
// forward's natural-log logsumexp, taken to the log2 domain once a row or a
// column: p = exp2(s * scale * log2(e) - lse * log2(e)). Q, K, V and g are
// bfloat16, so S and dP are exact in float32; P and dS enter their products
// as hi + lo bfloat16 fragments (a single rounding misses the one-ulp
// tolerance against the float32 plain version in 2.5-9% of the outputs, the
// split leaves 2^-17; tests/test_torch_mma_variants.py). Streamed rows travel
// through shared memory in chunks of 64 as bfloat16, double-buffered with
// cp.async, rows padded by 16 bytes so that ldmatrix reads them without bank
// conflicts (attention_mma.cuh's copy_chunk_pair). Rows past N or M arrive as
// zeros and are excluded by count (p = 0), never masked to a large negative
// number. A block holds up to 4 warps of 16 resident rows; a call with fewer
// than 132 blocks of 4 takes 2 warps or 1 a block (mma_warps).
//
// K11: a warp owns 16 query rows; the A fragments of Q and g and each
// thread's two rows of lse * log2(e) and delta stay in registers; K and V
// stream in chunks of 64 keys. Per chunk S = Q K^T and dP = g V^T (K and V as
// B without .trans), P and dS = P (dP - delta) in float32 on the C
// fragments, then dQ += dS K with dS's C fragments reused as A fragments (as
// the forward reuses P's) and K as B through ldmatrix .trans. dQ * scale is
// rounded once.
//
// K12: the transposed products. A warp owns 16 keys; the A fragments of K
// and V stay in registers; Q, g and the chunk's float32 lse and delta stream
// in chunks of 64 queries (lse and delta through shared memory, so that a
// thread reads the columns 8 j + 2 t, + 1 its C fragments hold). Per chunk
// S^T = K Q^T and dP^T = V g^T, P^T and dS^T, then dV += P^T g and
// dK += dS^T Q with g and Q as B through .trans. dK * scale and dV are
// rounded once.
#pragma once

#include "attention_mma.cuh"

namespace transmf {
namespace {

// p = exp2(s * c - l2) and ds = p * (dp - dl) for one element of a C
// fragment, in place (s becomes p, dp becomes ds); p = 0 unless `real`.
__device__ __forceinline__ void p_ds_pair(float& s, float& dp, float c,
                                          float l2, float dl, bool real) {
  const float p = real ? exp2f(s * c - l2) : 0.f;
  s = p;
  dp = p * (dp - dl);
}

// acc (16 rows x 16 KD columns) += A B over 16 streamed rows kk: A from the
// float32 C fragments x[2 kk], x[2 kk + 1] (rows = the warp's, columns =
// streamed rows) as hi + lo bfloat16 fragments, B from the chunk `src`
// stored [streamed row][D] through ldmatrix .trans.
template <int KD>
__device__ __forceinline__ void accumulate_split(float (&acc)[2 * KD][4],
                                                 const float (&x)[8][4],
                                                 const __nv_bfloat16* src,
                                                 int lane_off) {
  constexpr int RS = 16 * KD + kRowPad;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    unsigned hi[4], lo[4];
    split_bf16(x[2 * kk][0], x[2 * kk][1], hi[0], lo[0]);
    split_bf16(x[2 * kk][2], x[2 * kk][3], hi[1], lo[1]);
    split_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1], hi[2], lo[2]);
    split_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
    for (int dp = 0; dp < KD; ++dp) {
      unsigned b[4];
      ldmatrix_x4_trans(b, src + kk * 16 * RS + dp * 16 + lane_off);
      mma_bf16(acc[2 * dp], hi, b[0], b[1]);
      mma_bf16(acc[2 * dp + 1], hi, b[2], b[3]);
      mma_bf16(acc[2 * dp], lo, b[0], b[1]);
      mma_bf16(acc[2 * dp + 1], lo, b[2], b[3]);
    }
  }
}

// x (16 rows x 64 streamed rows) = A B^T: A the warp's fragments, B^T from
// the chunk `src` stored [streamed row][D] through ldmatrix without .trans.
template <int KD>
__device__ __forceinline__ void scores(float (&x)[8][4],
                                       const unsigned (&a)[KD][4],
                                       const __nv_bfloat16* src,
                                       int lane_off) {
  constexpr int RS = 16 * KD + kRowPad;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = 0.f;
  }
#pragma unroll
  for (int kc = 0; kc < KD; ++kc) {
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      unsigned b[4];
      ldmatrix_x4(b, src + jp * 16 * RS + kc * 16 + lane_off);
      mma_bf16(x[2 * jp], a[kc], b[0], b[1]);
      mma_bf16(x[2 * jp + 1], a[kc], b[2], b[3]);
    }
  }
}

// Rows r0 and r0 + 8 of a (rows, 16 KD) bfloat16 output from C fragments,
// each value times `factor`, rounded once.
template <int KD>
__device__ __forceinline__ void store_c_rows(__nv_bfloat16* dst,
                                             const float (&acc)[2 * KD][4],
                                             int r0, int rows, int t,
                                             float factor) {
  constexpr int D = 16 * KD;
#pragma unroll
  for (int j = 0; j < 2 * KD; ++j) {
    const int c = j * 8 + 2 * t;
    if (r0 < rows) {
      *reinterpret_cast<unsigned*>(dst + static_cast<int64_t>(r0) * D + c) =
          pack_bf16(acc[j][0] * factor, acc[j][1] * factor);
    }
    if (r0 + 8 < rows) {
      *reinterpret_cast<unsigned*>(dst + static_cast<int64_t>(r0 + 8) * D +
                                   c) =
          pack_bf16(acc[j][2] * factor, acc[j][3] * factor);
    }
  }
}

// K11 "mma". KD = D / 16; blockDim.x / 32 warps of 16 query rows.
template <int KD>
__global__ void __launch_bounds__(kMmaWarps * 32)
    flash_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dq, int N, int M,
                        int tiles, float scale) {
  constexpr int D = 16 * KD;
  constexpr int RS = D + kRowPad;
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
  dout += static_cast<int64_t>(bh) * N * D;
  dq += static_cast<int64_t>(bh) * N * D;
  k += static_cast<int64_t>(bh) * M * D;
  v += static_cast<int64_t>(bh) * M * D;
  lse += static_cast<int64_t>(bh) * N;
  delta += static_cast<int64_t>(bh) * N;
  const int r0 = row0 + g, r1 = r0 + 8;

  auto load_chunk = [&](int buf, int key0) {
    copy_chunk_pair<D>(ks, vs, k, v, buf, key0, M, tid, nthreads);
    cp_async_commit();
  };
  load_chunk(0, 0);

  unsigned qa[KD][4], ga[KD][4];
  load_a_rows<KD>(qa, q, r0, N, t);
  load_a_rows<KD>(ga, dout, r0, N, t);
  const float l0 = r0 < N ? lse[r0] * kLog2e : 0.f;
  const float l1 = r1 < N ? lse[r1] * kLog2e : 0.f;
  const float d0 = r0 < N ? delta[r0] : 0.f, d1 = r1 < N ? delta[r1] : 0.f;
  const float c = scale * kLog2e;

  float acc[2 * KD][4];
#pragma unroll
  for (int j = 0; j < 2 * KD; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }
  const bool active = row0 < N;  // the same for the whole warp
  const int b_lane = lane_nk(lane, RS), bt_lane = lane_kn(lane, RS);

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
      float s[8][4], dp[8][4];
      scores<KD>(s, qa, kb, b_lane);
      scores<KD>(dp, ga, vb, b_lane);
      const int nk = min(kChunk, M - ch * kChunk);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool top = e < 2;
          p_ds_pair(s[j][e], dp[j][e], c, top ? l0 : l1, top ? d0 : d1,
                    j * 8 + 2 * t + (e & 1) < nk);
        }
      }
      accumulate_split<KD>(acc, dp, kb, bt_lane);  // dQ += dS K
    }
    __syncthreads();  // chunk ch is read; the next load may overwrite it
  }
  if (active) store_c_rows<KD>(dq, acc, r0, N, t, scale);
}

// K12 "mma". KD = D / 16; blockDim.x / 32 warps of 16 keys.
template <int KD>
__global__ void __launch_bounds__(kMmaWarps * 32)
    flash_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int N, int M,
                         int tiles, float scale) {
  constexpr int D = 16 * KD;
  constexpr int RS = D + kRowPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // Q and g, [2][64][RS] each, then lse and delta, [2][64] floats each
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* gs = qs + 2 * kChunk * RS;
  float* lse_s = reinterpret_cast<float*>(gs + 2 * kChunk * RS);
  float* delta_s = lse_s + 2 * kChunk;

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x / tiles;
  const int key0 = (blockIdx.x % tiles) * (nthreads / 2) + warp * 16;
  q += static_cast<int64_t>(bh) * N * D;
  dout += static_cast<int64_t>(bh) * N * D;
  k += static_cast<int64_t>(bh) * M * D;
  v += static_cast<int64_t>(bh) * M * D;
  dk += static_cast<int64_t>(bh) * M * D;
  dv += static_cast<int64_t>(bh) * M * D;
  lse += static_cast<int64_t>(bh) * N;
  delta += static_cast<int64_t>(bh) * N;
  const int r0 = key0 + g;

  auto load_chunk = [&](int buf, int qrow0) {
    copy_chunk_pair<D>(qs, gs, q, dout, buf, qrow0, N, tid, nthreads);
    for (int i = tid; i < 2 * kChunk; i += nthreads) {
      const int r = i % kChunk;
      const bool real = qrow0 + r < N;
      const float* src = (i < kChunk ? lse : delta) + (real ? qrow0 + r : 0);
      cp_async4((i < kChunk ? lse_s : delta_s) + buf * kChunk + r, src,
                real);
    }
    cp_async_commit();
  };
  load_chunk(0, 0);

  unsigned ka[KD][4], va[KD][4];
  load_a_rows<KD>(ka, k, r0, M, t);
  load_a_rows<KD>(va, v, r0, M, t);
  const float c = scale * kLog2e;

  float acc_k[2 * KD][4], acc_v[2 * KD][4];
#pragma unroll
  for (int j = 0; j < 2 * KD; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[j][e] = acc_v[j][e] = 0.f;
  }
  const bool active = key0 < M;  // the same for the whole warp
  const int b_lane = lane_nk(lane, RS), bt_lane = lane_kn(lane, RS);

  const int chunks = (N + kChunk - 1) / kChunk;
  for (int ch = 0; ch < chunks; ++ch) {
    if (ch + 1 < chunks) {
      load_chunk((ch + 1) & 1, (ch + 1) * kChunk);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // every thread's pieces of chunk ch have landed
    if (active) {
      const int buf = ch & 1;
      const __nv_bfloat16* qb = qs + buf * kChunk * RS;
      const __nv_bfloat16* gb = gs + buf * kChunk * RS;
      float st[8][4], dpt[8][4];
      scores<KD>(st, ka, qb, b_lane);   // S^T = K Q^T
      scores<KD>(dpt, va, gb, b_lane);  // dP^T = V g^T
      const int nq = min(kChunk, N - ch * kChunk);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = j * 8 + 2 * t;
        const float2 lc = *reinterpret_cast<const float2*>(
            lse_s + buf * kChunk + col);
        const float2 dc = *reinterpret_cast<const float2*>(
            delta_s + buf * kChunk + col);
        const float la = lc.x * kLog2e, lb = lc.y * kLog2e;
        p_ds_pair(st[j][0], dpt[j][0], c, la, dc.x, col < nq);
        p_ds_pair(st[j][1], dpt[j][1], c, lb, dc.y, col + 1 < nq);
        p_ds_pair(st[j][2], dpt[j][2], c, la, dc.x, col < nq);
        p_ds_pair(st[j][3], dpt[j][3], c, lb, dc.y, col + 1 < nq);
      }
      accumulate_split<KD>(acc_v, st, gb, bt_lane);   // dV += P^T g
      accumulate_split<KD>(acc_k, dpt, qb, bt_lane);  // dK += dS^T Q
    }
    __syncthreads();  // chunk ch is read; the next load may overwrite it
  }
  if (active) {
    store_c_rows<KD>(dk, acc_k, r0, M, t, scale);
    store_c_rows<KD>(dv, acc_v, r0, M, t, 1.f);
  }
}

template <int KD>
int launch_flash_bwd_width(bool dkv, const void* q, const void* k,
                           const void* v, const void* dout, const void* lse,
                           const void* delta, void* out0, void* out1, int BH,
                           int N, int M, float scale, cudaStream_t stream) {
  using B = __nv_bfloat16;
  const int rows = dkv ? M : N;  // resident rows per (batch, head)
  const int warps = mma_warps(BH, rows);
  const int tiles = static_cast<int>(ceil_div(rows, 16 * warps));
  const int64_t blocks = static_cast<int64_t>(BH) * tiles;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(B) * 4 * kChunk * (16 * KD + kRowPad) +
                      (dkv ? sizeof(float) * 4 * kChunk : 0);
  const auto grid = static_cast<unsigned>(blocks);
  const auto* qp = static_cast<const B*>(q);
  const auto* kp = static_cast<const B*>(k);
  const auto* vp = static_cast<const B*>(v);
  const auto* gp = static_cast<const B*>(dout);
  const auto* lp = static_cast<const float*>(lse);
  const auto* dp = static_cast<const float*>(delta);
  if (dkv) {
    auto kernel = flash_dkv_mma_kernel<KD>;
    const cudaError_t st = allow_smem(kernel, smem);
    if (st != cudaSuccess) return static_cast<int>(st);
    kernel<<<grid, warps * 32, smem, stream>>>(
        qp, kp, vp, gp, lp, dp, static_cast<B*>(out0), static_cast<B*>(out1),
        N, M, tiles, scale);
  } else {
    auto kernel = flash_dq_mma_kernel<KD>;
    const cudaError_t st = allow_smem(kernel, smem);
    if (st != cudaSuccess) return static_cast<int>(st);
    kernel<<<grid, warps * 32, smem, stream>>>(
        qp, kp, vp, gp, lp, dp, static_cast<B*>(out0), N, M, tiles, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches K11 "mma" (dkv false: out0 = dq, (BH, N, D)) or K12 "mma" (dkv
// true: out0 = dk, out1 = dv, (BH, M, D)). q and g (BH, N, D), k and v
// (BH, M, D), all bfloat16 and 16-byte aligned, D in {16, 32, 64}; lse and
// delta (BH, N) float32; N, M >= 1. Refuses anything else. Returns the CUDA
// status.
int launch_flash_bwd_mma(bool dkv, const void* q, const void* k,
                         const void* v, const void* dout, const void* lse,
                         const void* delta, void* out0, void* out1, int BH,
                         int N, int M, int D, float scale, int dtype,
                         void* stream) {
  if (dtype != kBFloat16 || M < 1 || N < 1 || BH < 1 || !aligned16(q) ||
      !aligned16(k) || !aligned16(v) || !aligned16(dout) ||
      !aligned16(out0) || (dkv && !aligned16(out1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const auto width = [&](auto kd) {
    return launch_flash_bwd_width<decltype(kd)::value>(
        dkv, q, k, v, dout, lse, delta, out0, out1, BH, N, M, scale, st);
  };
  switch (D) {
    case 16: return width(std::integral_constant<int, 1>{});
    case 32: return width(std::integral_constant<int, 2>{});
    case 64: return width(std::integral_constant<int, 4>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace transmf
