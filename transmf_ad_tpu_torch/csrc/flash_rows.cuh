// The resident-row attention forward on the CUDA cores and the helpers it
// shares with the flash backward kernels: included by flash_attention.cu
// (K10, K11, K12) and by attention.cu (K2, which runs the same forward without
// the logsumexp store for float32 inputs and head dims the tensor-core kernel
// does not take). The design is described atop flash_attention.cu.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace transmf {
namespace {

constexpr int kMaxD = 128;
constexpr int kLanes = 32;  // streamed rows per chunk, one per lane
constexpr int kWarps = 4;
constexpr int kOwn = 8;                  // resident rows per warp
constexpr int kTile = kWarps * kOwn;     // resident rows per block
constexpr int kPatch = kOwn * kLanes;    // floats of one warp's p tile
static_assert(kTile == kLanes, "load_tile copies 32 rows of either kind");
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

// A tile of 32 rows of D values moves from device memory (row-major, D
// apart) to shared memory (float32, `stride` apart) in two steps, so that
// the reads of the next chunk are in flight while the block computes on
// this one. A thread stages rows warp, warp + 4, ... and columns lane + 32 t;
// a warp reads a row at a time, so the global reads coalesce.
constexpr int kStage = kLanes / kWarps;  // rows of a tile a thread stages

// Reads the thread's share of the tile at `src`: zero beyond `valid` rows
// and beyond D columns. Every read starts before any value is used.
template <typename T, int SLOTS>
__device__ __forceinline__ void fetch_tile(float (&reg)[kStage][SLOTS],
                                           const T* src, int valid, int D,
                                           int warp, int lane) {
#pragma unroll
  for (int i = 0; i < kStage; ++i) {
    const int r = warp + kWarps * i;
#pragma unroll
    for (int t = 0; t < SLOTS; ++t) {
      const int d = lane + 32 * t;
      reg[i][t] = (r < valid && d < D)
                      ? to_f32(src[static_cast<int64_t>(r) * D + d])
                      : 0.f;
    }
  }
}

// Writes the staged share into the tile `dst`, columns 0 .. Dp-1.
template <int SLOTS>
__device__ __forceinline__ void put_tile(float* dst, int stride,
                                         const float (&reg)[kStage][SLOTS],
                                         int Dp, int warp, int lane) {
#pragma unroll
  for (int i = 0; i < kStage; ++i) {
#pragma unroll
    for (int t = 0; t < SLOTS; ++t) {
      const int d = lane + 32 * t;
      if (d < Dp) dst[(warp + kWarps * i) * stride + d] = reg[i][t];
    }
  }
}

template <typename T, int SLOTS>
__device__ __forceinline__ void load_tile(float* dst, int stride, const T* src,
                                          int valid, int D, int Dp, int warp,
                                          int lane) {
  float reg[kStage][SLOTS];
  fetch_tile<T, SLOTS>(reg, src, valid, D, warp, lane);
  put_tile<SLOTS>(dst, stride, reg, Dp, warp, lane);
}

// s[r] = <own row r, mine> for the warp's kOwn resident rows (Dp apart,
// 16-byte aligned) and the lane's streamed row.
__device__ __forceinline__ void dots(const float* own, int Dp, const float* mine,
                                     float (&s)[kOwn]) {
#pragma unroll
  for (int r = 0; r < kOwn; ++r) s[r] = 0.f;
  for (int d = 0; d < Dp; d += 4) {
    const float x0 = mine[d], x1 = mine[d + 1], x2 = mine[d + 2],
                x3 = mine[d + 3];
#pragma unroll
    for (int r = 0; r < kOwn; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(own + r * Dp + d);
      s[r] = fmaf(a.x, x0, s[r]);
      s[r] = fmaf(a.y, x1, s[r]);
      s[r] = fmaf(a.z, x2, s[r]);
      s[r] = fmaf(a.w, x3, s[r]);
    }
  }
}

// acc[r][t] += sum over the chunk's 32 streamed rows j of
// w[r * 32 + j] * x[j * stride + lane + 32 t].
template <int SLOTS>
__device__ __forceinline__ void accumulate(const float* w, const float* x,
                                           int stride, int D, int lane,
                                           float (&acc)[kOwn][SLOTS]) {
#pragma unroll
  for (int t = 0; t < SLOTS; ++t) {
    const int d = lane + 32 * t;
    if (d >= D) continue;
    for (int j = 0; j < kLanes; j += 4) {
      const float x0 = x[j * stride + d], x1 = x[(j + 1) * stride + d],
                  x2 = x[(j + 2) * stride + d], x3 = x[(j + 3) * stride + d];
#pragma unroll
      for (int r = 0; r < kOwn; ++r) {
        const float4 a = *reinterpret_cast<const float4*>(w + r * kLanes + j);
        acc[r][t] = fmaf(a.x, x0, acc[r][t]);
        acc[r][t] = fmaf(a.y, x1, acc[r][t]);
        acc[r][t] = fmaf(a.z, x2, acc[r][t]);
        acc[r][t] = fmaf(a.w, x3, acc[r][t]);
      }
    }
  }
}

// Writes the warp's kOwn x D accumulator rows `first` .. (below `limit`),
// each value times `factor`, rounded once to the storage type.
template <typename T, int SLOTS>
__device__ __forceinline__ void store_rows(T* dst, int first, int limit, int D,
                                           int lane, float factor,
                                           const float (&acc)[kOwn][SLOTS]) {
#pragma unroll
  for (int r = 0; r < kOwn; ++r) {
    if (first + r >= limit) continue;
#pragma unroll
    for (int t = 0; t < SLOTS; ++t) {
      const int d = lane + 32 * t;
      if (d < D) {
        dst[static_cast<int64_t>(first + r) * D + d] =
            from_f32<T>(acc[r][t] * factor);
      }
    }
  }
}

__host__ __device__ inline int pad4(int D) { return (D + 3) & ~3; }

// Floats of dynamic shared memory: `own` resident tiles, `patches` p tiles,
// two streamed tiles.
inline size_t smem_bytes(int D, int own, int patches) {
  const int Dp = pad4(D);
  return sizeof(float) * (static_cast<size_t>(own) * kTile * Dp +
                          static_cast<size_t>(patches) * kWarps * kPatch +
                          2u * kLanes * (Dp + 1));
}

// K10, and K2 on the CUDA cores (kLse false: `lse` is neither computed nor
// stored). Resident: 32 query rows; streamed: K and V.
template <typename T, int SLOTS, bool kLse>
__global__ void __launch_bounds__(kWarps * 32)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int N, int M, int D, int tiles,
                     float scale) {
  extern __shared__ float4 smem4[];
  const int Dp = pad4(D), stride = Dp + 1;
  float* qs = reinterpret_cast<float*>(smem4);
  float* ps = qs + kTile * Dp;
  float* ks = ps + kWarps * kPatch;
  float* vs = ks + kLanes * stride;

  const int bh = blockIdx.x / tiles;
  const int row0 = (blockIdx.x % tiles) * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t qbase = static_cast<int64_t>(bh) * N * D;
  const int64_t kbase = static_cast<int64_t>(bh) * M * D;

  load_tile<T, SLOTS>(qs, Dp, q + qbase + static_cast<int64_t>(row0) * D,
                      min(kTile, N - row0), D, Dp, warp, lane);
  const float* own = qs + warp * kOwn * Dp;
  float* patch = ps + warp * kPatch;

  float m_run[kOwn], l_run[kOwn], acc[kOwn][SLOTS];
#pragma unroll
  for (int r = 0; r < kOwn; ++r) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
#pragma unroll
    for (int t = 0; t < SLOTS; ++t) acc[r][t] = 0.f;
  }

  float k_next[kStage][SLOTS], v_next[kStage][SLOTS];
  fetch_tile<T, SLOTS>(k_next, k + kbase, min(kLanes, M), D, warp, lane);
  fetch_tile<T, SLOTS>(v_next, v + kbase, min(kLanes, M), D, warp, lane);
  for (int key0 = 0; key0 < M; key0 += kLanes) {
    const int nk = min(kLanes, M - key0);
    __syncthreads();  // the previous chunk (and the q tile) is settled
    put_tile<SLOTS>(ks, stride, k_next, Dp, warp, lane);
    put_tile<SLOTS>(vs, stride, v_next, Dp, warp, lane);
    __syncthreads();
    if (key0 + kLanes < M) {
      const int64_t off = kbase + static_cast<int64_t>(key0 + kLanes) * D;
      const int valid = min(kLanes, M - key0 - kLanes);
      fetch_tile<T, SLOTS>(k_next, k + off, valid, D, warp, lane);
      fetch_tile<T, SLOTS>(v_next, v + off, valid, D, warp, lane);
    }

    float s[kOwn];
    dots(own, Dp, ks + lane * stride, s);
#pragma unroll
    for (int r = 0; r < kOwn; ++r) {
      const float sv = lane < nk ? s[r] * scale : -INFINITY;
      // every chunk holds at least one real key, so m_new is finite
      const float m_new = fmaxf(m_run[r], warp_max(sv));
      const float alpha = expf(m_run[r] - m_new);
      const float p = lane < nk ? expf(sv - m_new) : 0.f;
      l_run[r] = l_run[r] * alpha + warp_sum(p);
#pragma unroll
      for (int t = 0; t < SLOTS; ++t) acc[r][t] *= alpha;
      m_run[r] = m_new;
      patch[r * kLanes + lane] = p;
    }
    __syncwarp();
    accumulate<SLOTS>(patch, vs, stride, D, lane, acc);
  }

  const int first = row0 + warp * kOwn;
#pragma unroll
  for (int r = 0; r < kOwn; ++r) {
    if (kLse && lane == 0 && first + r < N) {
      lse[static_cast<int64_t>(bh) * N + first + r] = m_run[r] + logf(l_run[r]);
    }
    const float inv = 1.f / l_run[r];
#pragma unroll
    for (int t = 0; t < SLOTS; ++t) acc[r][t] *= inv;
  }
  store_rows<T, SLOTS>(o + qbase, first, N, D, lane, 1.f, acc);
}

// Calls f(T{}, integral_constant<int, SLOTS>{}) for the storage type named by
// `dtype` and the accumulator width that covers D; f returns a CUDA status.
template <typename F>
int for_type_and_width(int dtype, int D, F f) {
  auto by_width = [&](auto tag) -> int {
    if (D <= 32) return f(tag, std::integral_constant<int, 1>{});
    if (D <= 64) return f(tag, std::integral_constant<int, 2>{});
    return f(tag, std::integral_constant<int, 4>{});
  };
  if (dtype == kFloat32) return by_width(float{});
  if (dtype == kBFloat16) return by_width(__nv_bfloat16{});
  return static_cast<int>(cudaErrorInvalidValue);
}

// Blocks of a launch over `rows` resident rows per (batch, head), or 0 when
// the sizes are refused.
inline int64_t grid_blocks(int BH, int rows, int other, int D) {
  if (D < 1 || D > kMaxD || rows < 1 || other < 1 || BH < 1) return 0;
  const int64_t blocks = static_cast<int64_t>(BH) * ceil_div(rows, kTile);
  return blocks > 0x7fffffff ? 0 : blocks;
}

// Launches the forward above. q: (BH, N, D); k, v: (BH, M, D); o: (BH, N, D);
// lse: (BH, N) float32, written when kLse. Needs 1 <= D <= 128, N >= 1,
// M >= 1. Returns the CUDA status.
template <bool kLse>
int launch_flash_fwd(const void* q, const void* k, const void* v, void* o,
                     void* lse, int BH, int N, int M, int D, float scale,
                     int dtype, void* stream) {
  const int64_t blocks = grid_blocks(BH, N, M, D);
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = static_cast<int>(ceil_div(N, kTile));
  const size_t smem = smem_bytes(D, 1, 1);
  return for_type_and_width(dtype, D, [&](auto tag, auto width) -> int {
    using T = decltype(tag);
    auto kernel = flash_fwd_kernel<T, decltype(width)::value, kLse>;
    const cudaError_t st = allow_smem(kernel, smem);
    if (st != cudaSuccess) return static_cast<int>(st);
    kernel<<<static_cast<unsigned>(blocks), kWarps * 32, smem,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
        N, M, D, tiles, scale);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace
}  // namespace transmf
