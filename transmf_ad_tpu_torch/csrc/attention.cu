// K2: single-pass attention forward, softmax(q k^T * scale) v.
//
// Replaces: transmf_ad_tpu/ops/flash_attention.py::_attention_kernel
// (pallas_call at flash_attention.py:78). The TPU kernel holds one query
// block and the whole K/V of a (batch, head) in VMEM, pads keys to a multiple
// of 8 and masks the padding to -1e30 before one softmax pass.
//
// Bound on the card: at the model's shape (B*H = 32, 150 tokens, head 32) the
// whole problem is 2.9 MFLOP and 1.2 MB, so launch latency bounds it. At the
// full-resolution grid (1,573 tokens) it is the float32 FMA rate of the
// CUDA cores: this first kernel does not use the tensor cores.
//
// Design: a whole 2048 x 128 float32 K+V is 2 MB and does not fit the 227 KB
// of shared memory a block may use, so K/V stream through shared memory in
// chunks of 32 keys with an online softmax (running max and sum per query
// row, accumulator rescaled when the max grows). One block of 4 warps owns
// 16 query rows of one (batch, head); each warp owns 4 rows. For a chunk,
// lane j scores key j (the K rows are padded to D+1 floats so the 32 lanes
// hit 32 banks), the warp reduces max and sum with shuffles, and each lane
// accumulates the output columns d = lane + 32 t. Keys past M are excluded by
// count, never padded. Scores, the normaliser and the output accumulator are
// float32; the output is rounded once to the storage type.
#include "common.cuh"

namespace transmf {
namespace {

constexpr int kMaxD = 128;
constexpr int kKeys = 32;  // keys per shared-memory chunk, one per lane
constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;
constexpr int kSlots = kMaxD / 32;  // output columns per lane
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ o, int N,
                         int M, int D, int tiles, float scale) {
  __shared__ float qs[kRows][kMaxD];
  __shared__ float ks[kKeys][kMaxD + 1];
  __shared__ float vs[kKeys][kMaxD];

  const int bh = blockIdx.x / tiles;
  const int row0 = (blockIdx.x % tiles) * kRows;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int64_t qbase = static_cast<int64_t>(bh) * N * D;
  const int64_t kbase = static_cast<int64_t>(bh) * M * D;

  for (int i = tid; i < kRows * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    const int n = row0 + r;
    qs[r][d] = n < N ? to_f32(q[qbase + static_cast<int64_t>(n) * D + d]) : 0.f;
  }

  float m_run[kRowsPerWarp], l_run[kRowsPerWarp];
  float acc[kRowsPerWarp][kSlots];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
#pragma unroll
    for (int t = 0; t < kSlots; ++t) acc[r][t] = 0.f;
  }

  for (int key0 = 0; key0 < M; key0 += kKeys) {
    const int nk = min(kKeys, M - key0);
    __syncthreads();  // the previous chunk (and the q tile) is settled
    for (int i = tid; i < kKeys * D; i += blockDim.x) {
      const int j = i / D, d = i % D;
      const int64_t off = kbase + static_cast<int64_t>(key0 + j) * D + d;
      ks[j][d] = j < nk ? to_f32(k[off]) : 0.f;
      vs[j][d] = j < nk ? to_f32(v[off]) : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int lr = warp * kRowsPerWarp + r;
      float s = -INFINITY;
      if (lane < nk) {
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot = fmaf(qs[lr][d], ks[lane][d], dot);
        s = dot * scale;
      }
      // every chunk holds at least one real key, so m_new is finite
      const float m_new = fmaxf(m_run[r], warp_max(s));
      const float alpha = expf(m_run[r] - m_new);
      const float p = lane < nk ? expf(s - m_new) : 0.f;
      l_run[r] = l_run[r] * alpha + warp_sum(p);
#pragma unroll
      for (int t = 0; t < kSlots; ++t) acc[r][t] *= alpha;
      for (int j = 0; j < nk; ++j) {
        const float pj = __shfl_sync(kFull, p, j);
#pragma unroll
        for (int t = 0; t < kSlots; ++t) {
          const int d = lane + 32 * t;
          if (d < D) acc[r][t] = fmaf(pj, vs[j][d], acc[r][t]);
        }
      }
      m_run[r] = m_new;
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int n = row0 + warp * kRowsPerWarp + r;
    if (n >= N) continue;
    const float inv = 1.f / l_run[r];
#pragma unroll
    for (int t = 0; t < kSlots; ++t) {
      const int d = lane + 32 * t;
      if (d < D) {
        o[qbase + static_cast<int64_t>(n) * D + d] =
            from_f32<T>(acc[r][t] * inv);
      }
    }
  }
}

}  // namespace
}  // namespace transmf

// q: (BH, N, D); k, v: (BH, M, D); o: (BH, N, D). Needs 1 <= D <= 128, M >= 1.
extern "C" int transmf_attention_fwd(const void* q, const void* k,
                                     const void* v, void* o, int BH, int N,
                                     int M, int D, float scale, int dtype,
                                     void* stream) {
  using namespace transmf;
  if (D < 1 || D > kMaxD || M < 1 || N < 1 || BH < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles = static_cast<int>(ceil_div(N, kRows));
  const int64_t blocks = static_cast<int64_t>(BH) * tiles;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(dtype, [&](auto tag) {
    using T = decltype(tag);
    attention_fwd_kernel<T><<<static_cast<unsigned>(blocks), kWarps * 32, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), N, M, D, tiles, scale);
  });
}
