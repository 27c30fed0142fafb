// K10, K11, K12: KV-blocked flash attention: forward with saved logsumexp,
// dq, and dk/dv.
//
// Replace: transmf_ad_tpu/ops/flash_attention.py::_flash_fwd_kernel
// (pallas_call at flash_attention.py:222), ::_flash_dq_kernel (:343) and
// ::_flash_dkv_kernel (:361). The TPU kernels walk a (batch*head, q block,
// kv block) grid in order, carry the running max, sum and accumulators in
// VMEM scratch from one grid step to the next, pad N, M and D to the tiling
// and mask padded keys to -1e30. Here a loop inside the block takes the place
// of the innermost grid axis, and rows past N or M are excluded by count.
//
//   forward  out = softmax(q k^T * scale) v,  lse = m + log(l) per query row
//   dq       p = exp(s - lse), dp = g v^T, ds = p * (dp - delta),
//            dq = (sum over keys of ds k) * scale
//   dk/dv    the same p and ds; dv = sum over queries of p^T g,
//            dk = (sum over queries of ds^T q) * scale
// with s = q k^T * scale and delta = rowsum(g * out), which the wrapper
// computes from the rounded output. The (N, M) score matrix never exists in
// device memory, forward or backward.
//
// Bound on the card: at the model's shape (batch*heads 24, 1,573 queries,
// 3,146 keys, head 32) the three kernels do 15.2, 22.8 and 30.4 GFLOP on 14
// to 22 MB, so the operations bound them.
//
// Each kernel has two variants, chosen by the caller from the dtype and the
// head dim alone. The forward takes K2's rule
// (ops/flash_attention.py::attention_variant): "mma" for bfloat16 with D =
// 16, 32, 64 or 128, K2's tensor-core forward with the logsumexp store
// compiled in (attention_mma.cuh). K11 and K12 take
// ops/flash_attention.py::flash_bwd_variant: "mma" for bfloat16 with D = 16,
// 32 or 64, FlashAttention-2's backward on the tensor cores
// (flash_bwd_mma.cuh; at D = 128 K12's four accumulators and score tiles
// would not fit the registers). Every other case is "rows", the
// resident-row design below: float32 arithmetic on the CUDA cores (the
// float32 check against the plain version holds to 1e-4, which TF32 or
// bfloat16 tensor-core products would not), whose rate is the 67 TFLOP/s of
// the float32 pipes.
//
// "rows", shared by the three kernels. A block of 4 warps keeps 32 RESIDENT
// rows in shared memory (queries for the forward and dq, keys for dk/dv),
// 8 per warp, and STREAMS the other side through shared memory in chunks of
// 32 rows, one per lane:
//   1. scores: lane j dots its streamed row with the warp's 8 resident rows.
//      The streamed tile has an odd row stride (no bank conflicts across
//      lanes); the resident rows are read as float4 broadcasts, so 12 shared
//      loads feed 32 FMAs. D is zero-padded to a multiple of 4 for that.
//   2. the 8 x 32 tile of p (and ds) goes through a warp-private patch of
//      shared memory, so that
//   3. each lane accumulates the output columns d = lane + 32 t of the
//      warp's 8 resident rows over the chunk's 32 streamed rows, again with
//      float4 broadcasts of p.
// The next chunk's rows are read into registers before the block computes on
// the current one, so device-memory latency hides behind the arithmetic.
// Each output element is owned by one thread and written once: no atomics,
// so every result is the same from run to run. The forward keeps a running
// max and sum per query row (online softmax); the backward kernels use the
// saved lse and never recompute a max. Offsets are 64-bit. The accumulator
// width is a template parameter (1, 2 or 4 columns per lane for D <= 32, 64,
// 128), so that D = 32 does not pay registers for D = 128.
#include "attention_mma.cuh"
#include "flash_bwd_mma.cuh"
#include "flash_rows.cuh"

namespace transmf {
namespace {

// K11. Resident: 32 query rows with their g, lse and delta; streamed: K, V.
template <typename T, int SLOTS>
__global__ void __launch_bounds__(kWarps * 32)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ g,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int N,
                    int M, int D, int tiles, float scale) {
  extern __shared__ float4 smem4[];
  const int Dp = pad4(D), stride = Dp + 1;
  float* qs = reinterpret_cast<float*>(smem4);
  float* gs = qs + kTile * Dp;
  float* dss = gs + kTile * Dp;
  float* ks = dss + kWarps * kPatch;
  float* vs = ks + kLanes * stride;

  const int bh = blockIdx.x / tiles;
  const int row0 = (blockIdx.x % tiles) * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t qbase = static_cast<int64_t>(bh) * N * D;
  const int64_t kbase = static_cast<int64_t>(bh) * M * D;
  const int64_t qoff = qbase + static_cast<int64_t>(row0) * D;

  load_tile<T, SLOTS>(qs, Dp, q + qoff, min(kTile, N - row0), D, Dp, warp,
                      lane);
  load_tile<T, SLOTS>(gs, Dp, g + qoff, min(kTile, N - row0), D, Dp, warp,
                      lane);
  const float* own_q = qs + warp * kOwn * Dp;
  const float* own_g = gs + warp * kOwn * Dp;
  float* patch = dss + warp * kPatch;

  const int first = row0 + warp * kOwn;
  float lse_r[kOwn], delta_r[kOwn], acc[kOwn][SLOTS];
#pragma unroll
  for (int r = 0; r < kOwn; ++r) {
    const bool real = first + r < N;
    const int64_t i = static_cast<int64_t>(bh) * N + first + r;
    lse_r[r] = real ? lse[i] : 0.f;
    delta_r[r] = real ? delta[i] : 0.f;
#pragma unroll
    for (int t = 0; t < SLOTS; ++t) acc[r][t] = 0.f;
  }

  float k_next[kStage][SLOTS], v_next[kStage][SLOTS];
  fetch_tile<T, SLOTS>(k_next, k + kbase, min(kLanes, M), D, warp, lane);
  fetch_tile<T, SLOTS>(v_next, v + kbase, min(kLanes, M), D, warp, lane);
  for (int key0 = 0; key0 < M; key0 += kLanes) {
    const int nk = min(kLanes, M - key0);
    __syncthreads();
    put_tile<SLOTS>(ks, stride, k_next, Dp, warp, lane);
    put_tile<SLOTS>(vs, stride, v_next, Dp, warp, lane);
    __syncthreads();
    if (key0 + kLanes < M) {
      const int64_t off = kbase + static_cast<int64_t>(key0 + kLanes) * D;
      const int valid = min(kLanes, M - key0 - kLanes);
      fetch_tile<T, SLOTS>(k_next, k + off, valid, D, warp, lane);
      fetch_tile<T, SLOTS>(v_next, v + off, valid, D, warp, lane);
    }

    float s[kOwn], dp[kOwn];
    dots(own_q, Dp, ks + lane * stride, s);
    dots(own_g, Dp, vs + lane * stride, dp);
#pragma unroll
    for (int r = 0; r < kOwn; ++r) {
      const float p = lane < nk ? expf(s[r] * scale - lse_r[r]) : 0.f;
      patch[r * kLanes + lane] = p * (dp[r] - delta_r[r]);
    }
    __syncwarp();
    accumulate<SLOTS>(patch, ks, stride, D, lane, acc);
  }
  store_rows<T, SLOTS>(dq + qbase, first, N, D, lane, scale, acc);
}

// K12. Resident: 32 keys with their values; streamed: q and g, with the lse
// and delta of the lane's query row.
template <typename T, int SLOTS>
__global__ void __launch_bounds__(kWarps * 32)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ g,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int N, int M, int D, int tiles,
                     float scale) {
  extern __shared__ float4 smem4[];
  const int Dp = pad4(D), stride = Dp + 1;
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + kTile * Dp;
  float* pss = vs + kTile * Dp;
  float* dss = pss + kWarps * kPatch;
  float* qs = dss + kWarps * kPatch;
  float* gs = qs + kLanes * stride;

  const int bh = blockIdx.x / tiles;
  const int key0 = (blockIdx.x % tiles) * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t qbase = static_cast<int64_t>(bh) * N * D;
  const int64_t kbase = static_cast<int64_t>(bh) * M * D;
  const int64_t koff = kbase + static_cast<int64_t>(key0) * D;

  load_tile<T, SLOTS>(ks, Dp, k + koff, min(kTile, M - key0), D, Dp, warp,
                      lane);
  load_tile<T, SLOTS>(vs, Dp, v + koff, min(kTile, M - key0), D, Dp, warp,
                      lane);
  const float* own_k = ks + warp * kOwn * Dp;
  const float* own_v = vs + warp * kOwn * Dp;
  float* p_patch = pss + warp * kPatch;
  float* ds_patch = dss + warp * kPatch;

  float acc_k[kOwn][SLOTS], acc_v[kOwn][SLOTS];
#pragma unroll
  for (int r = 0; r < kOwn; ++r) {
#pragma unroll
    for (int t = 0; t < SLOTS; ++t) acc_k[r][t] = acc_v[r][t] = 0.f;
  }

  // lse and delta of the lane's query row, staged like the tiles
  const float* lse_bh = lse + static_cast<int64_t>(bh) * N;
  const float* delta_bh = delta + static_cast<int64_t>(bh) * N;
  float q_next[kStage][SLOTS], g_next[kStage][SLOTS];
  fetch_tile<T, SLOTS>(q_next, q + qbase, min(kLanes, N), D, warp, lane);
  fetch_tile<T, SLOTS>(g_next, g + qbase, min(kLanes, N), D, warp, lane);
  float lse_next = lane < N ? lse_bh[lane] : 0.f;
  float delta_next = lane < N ? delta_bh[lane] : 0.f;
  for (int row0 = 0; row0 < N; row0 += kLanes) {
    const bool real = lane < min(kLanes, N - row0);
    __syncthreads();  // the previous chunk (and the K, V tiles) is settled
    put_tile<SLOTS>(qs, stride, q_next, Dp, warp, lane);
    put_tile<SLOTS>(gs, stride, g_next, Dp, warp, lane);
    const float lse_i = lse_next, delta_i = delta_next;
    __syncthreads();
    if (row0 + kLanes < N) {
      const int next = row0 + kLanes;
      const int64_t off = qbase + static_cast<int64_t>(next) * D;
      fetch_tile<T, SLOTS>(q_next, q + off, min(kLanes, N - next), D, warp,
                           lane);
      fetch_tile<T, SLOTS>(g_next, g + off, min(kLanes, N - next), D, warp,
                           lane);
      lse_next = next + lane < N ? lse_bh[next + lane] : 0.f;
      delta_next = next + lane < N ? delta_bh[next + lane] : 0.f;
    }

    float s[kOwn], dp[kOwn];
    dots(own_k, Dp, qs + lane * stride, s);
    dots(own_v, Dp, gs + lane * stride, dp);
#pragma unroll
    for (int r = 0; r < kOwn; ++r) {
      const float p = real ? expf(s[r] * scale - lse_i) : 0.f;
      p_patch[r * kLanes + lane] = p;
      ds_patch[r * kLanes + lane] = p * (dp[r] - delta_i);
    }
    __syncwarp();
    accumulate<SLOTS>(p_patch, gs, stride, D, lane, acc_v);
    accumulate<SLOTS>(ds_patch, qs, stride, D, lane, acc_k);
  }
  const int first = key0 + warp * kOwn;
  store_rows<T, SLOTS>(dk + kbase, first, M, D, lane, scale, acc_k);
  store_rows<T, SLOTS>(dv + kbase, first, M, D, lane, 1.f, acc_v);
}

}  // namespace
}  // namespace transmf

// q: (BH, N, D); k, v: (BH, M, D); o: (BH, N, D); lse: (BH, N) float32.
// Needs 1 <= D <= 128, N >= 1, M >= 1. variant 1 ("mma", attention_mma.cuh):
// bfloat16, D in {16, 32, 64, 128}, 16-byte aligned q, k, v, o; variant 0
// ("rows"): any dtype and D.
extern "C" int transmf_flash_fwd(const void* q, const void* k, const void* v,
                                 void* o, void* lse, int BH, int N, int M,
                                 int D, float scale, int dtype, int variant,
                                 void* stream) {
  using namespace transmf;
  if (variant == 0) {
    return launch_flash_fwd<true>(q, k, v, o, lse, BH, N, M, D, scale, dtype,
                                  stream);
  }
  if (variant != 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch_attention_mma<true>(q, k, v, o, lse, BH, N, M, D, scale,
                                    dtype, stream);
}

// q, g, dq: (BH, N, D); k, v: (BH, M, D); lse, delta: (BH, N) float32.
// variant 1 ("mma", flash_bwd_mma.cuh): bfloat16, D in {16, 32, 64},
// 16-byte aligned q, k, v, g, dq; variant 0 ("rows"): any dtype and D.
extern "C" int transmf_flash_dq(const void* q, const void* k, const void* v,
                                const void* g, const void* lse,
                                const void* delta, void* dq, int BH, int N,
                                int M, int D, float scale, int dtype,
                                int variant, void* stream) {
  using namespace transmf;
  if (variant == 1) {
    return launch_flash_bwd_mma(false, q, k, v, g, lse, delta, dq, nullptr,
                                BH, N, M, D, scale, dtype, stream);
  }
  if (variant != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = grid_blocks(BH, N, M, D);
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = static_cast<int>(ceil_div(N, kTile));
  const size_t smem = smem_bytes(D, 2, 1);
  return for_type_and_width(dtype, D, [&](auto tag, auto width) -> int {
    using T = decltype(tag);
    auto kernel = flash_dq_kernel<T, decltype(width)::value>;
    const cudaError_t st = allow_smem(kernel, smem);
    if (st != cudaSuccess) return static_cast<int>(st);
    kernel<<<static_cast<unsigned>(blocks), kWarps * 32, smem,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(g),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<T*>(dq), N, M, D, tiles, scale);
    return static_cast<int>(cudaGetLastError());
  });
}

// q, g: (BH, N, D); k, v, dk, dv: (BH, M, D); lse, delta: (BH, N) float32.
// Variants as for transmf_flash_dq, dk and dv 16-byte aligned for "mma".
extern "C" int transmf_flash_dkv(const void* q, const void* k, const void* v,
                                 const void* g, const void* lse,
                                 const void* delta, void* dk, void* dv, int BH,
                                 int N, int M, int D, float scale, int dtype,
                                 int variant, void* stream) {
  using namespace transmf;
  if (variant == 1) {
    return launch_flash_bwd_mma(true, q, k, v, g, lse, delta, dk, dv, BH, N,
                                M, D, scale, dtype, stream);
  }
  if (variant != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = grid_blocks(BH, M, N, D);
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = static_cast<int>(ceil_div(M, kTile));
  const size_t smem = smem_bytes(D, 2, 2);
  return for_type_and_width(dtype, D, [&](auto tag, auto width) -> int {
    using T = decltype(tag);
    auto kernel = flash_dkv_kernel<T, decltype(width)::value>;
    const cudaError_t st = allow_smem(kernel, smem);
    if (st != cudaSuccess) return static_cast<int>(st);
    kernel<<<static_cast<unsigned>(blocks), kWarps * 32, smem,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(g),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<T*>(dk), static_cast<T*>(dv), N, M, D, tiles, scale);
    return static_cast<int>(cudaGetLastError());
  });
}
