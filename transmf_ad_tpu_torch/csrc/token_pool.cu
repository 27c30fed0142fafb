// K1: fused dual-modality token pooling, (B, N, D) x 2 -> (B, 4D).
//
// Replaces: transmf_ad_tpu/ops/pooling.py::_pool_kernel (pallas_call at
// pooling.py:37), which holds both token tensors in VMEM and writes the row
// [mean mri, mean pet, max mri, max pet] in one pass.
//
// Bound on the card: bytes. Both token tensors are read once and (B, 4D) is
// written: at the full-resolution fusion head (6, 1573, 128) x 2 in bf16
// that is 4.84 MB, 1.4 us of HBM time; at (8, 150, 128) x 2, 0.62 MB.
// Sums and maxima are kept in float32 and rounded once to the storage type,
// as the TPU kernel does. No atomics: the order of every sum is a pure
// function of the shape, so a call repeats its bits.
//
// Two variants, chosen in the wrapper by dtype and D alone
// (ops/pooling.py::variant):
//
// "cluster" (1), wherever a token row of D channels is a whole number of
// 16-byte pieces, at most 256 of them (bf16 D % 8 == 0, float32 D % 4 == 0:
// the models' widths). Each batch row gets a thread-block cluster of 8
// blocks of 256 threads (grid (8, B), the cluster's size fixed at compile
// time, so the launch is a plain one); block `rank` takes the tokens
// [rank * chunk, (rank + 1) * chunk), chunk = ceil(N / 8), the last chunks
// short or empty. A thread owns one 16-byte group of V
// channels (8 bf16, 4 float32) of one row slot: L = D / V threads cover a
// token row, so a block has R = 256 / L rows in flight (16 at bf16 D 128).
// Row slot r walks the tokens n0 + r, n0 + r + R, ... in order, reading
// kUnroll tokens of each modality before it adds them (8 loads of 16 bytes
// in flight a thread), and keeps float32 sums and maxima of its V channels
// of both modalities in registers. Then, in a fixed order: the block adds
// its R row slots in shared memory in slot order, and the cluster's rank-0
// block adds its peers' block results through distributed shared memory in
// rank order (its 7 peers' values are loaded before the first add), divides
// the sums by N and writes the row.
//
// "column" (0, the first design), every other shape: one thread per (b, d)
// walks all N tokens with 2- or 4-byte loads; a warp covers 32 neighbouring
// d of one token row, so every load of the token loop is one coalesced
// segment. At the full-resolution head that is 6 blocks, and its time is
// the latency of 1,573 dependent loads.
#include <cooperative_groups.h>

#include <cstdint>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace transmf {
namespace {

constexpr int kColumnThreads = 128;
constexpr int kClusterThreads = 256;
constexpr int kClusterSize = 8;  // the portable cluster size
constexpr int kUnroll = 4;      // tokens of each modality read before adding

template <typename T>
__global__ void token_pool_kernel(const T* __restrict__ mri,
                                  const T* __restrict__ pet,
                                  T* __restrict__ out, int B, int N, int D) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (idx >= static_cast<int64_t>(B) * D) return;
  const int b = static_cast<int>(idx / D);
  const int d = static_cast<int>(idx % D);
  const T* m = mri + static_cast<int64_t>(b) * N * D + d;
  const T* p = pet + static_cast<int64_t>(b) * N * D + d;
  float sum_m = 0.f, sum_p = 0.f;
  float max_m = -INFINITY, max_p = -INFINITY;
  for (int n = 0; n < N; ++n) {
    const float a = to_f32(m[static_cast<int64_t>(n) * D]);
    const float c = to_f32(p[static_cast<int64_t>(n) * D]);
    sum_m += a;
    sum_p += c;
    max_m = fmaxf(max_m, a);
    max_p = fmaxf(max_p, c);
  }
  T* o = out + static_cast<int64_t>(b) * 4 * D + d;
  o[0] = from_f32<T>(sum_m / static_cast<float>(N));
  o[D] = from_f32<T>(sum_p / static_cast<float>(N));
  o[2 * D] = from_f32<T>(max_m);
  o[3 * D] = from_f32<T>(max_p);
}

// The V channels of a 16-byte vector as float32: a word holds one float32
// or two bf16 (the lower address in the low half).
__device__ __forceinline__ void unpack(const uint4& q, float (&f)[4]) {
  f[0] = __uint_as_float(q.x);
  f[1] = __uint_as_float(q.y);
  f[2] = __uint_as_float(q.z);
  f[3] = __uint_as_float(q.w);
}
__device__ __forceinline__ void unpack(const uint4& q, float (&f)[8]) {
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <int V>
__device__ __forceinline__ void add_token(const uint4& q, float (&sum)[V],
                                          float (&best)[V]) {
  float f[V];
  unpack(q, f);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    sum[j] += f[j];
    best[j] = fmaxf(best[j], f[j]);
  }
}

template <int V>
__device__ __forceinline__ void store(float* dst, const float (&v)[V]) {
#pragma unroll
  for (int j = 0; j < V; ++j) dst[j] = v[j];
}

// part[(s * R + r) * D + d]: statistic s (0 sum mri, 1 sum pet, 2 max mri,
// 3 max pet) of row slot r, channel d; R * D <= 256 * V.
template <typename T>
__global__ void __cluster_dims__(kClusterSize, 1, 1)
    __launch_bounds__(kClusterThreads) token_pool_cluster_kernel(const T* __restrict__ mri,
                              const T* __restrict__ pet, T* __restrict__ out,
                              int N, int D, int chunk) {
  constexpr int V = 16 / sizeof(T);
  __shared__ float part[4 * kClusterThreads * V];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int L = D / V;
  const int R = kClusterThreads / L;
  const int slot = threadIdx.x / L, lane = threadIdx.x - slot * L;
  const int b = blockIdx.y;
  const int n0 = rank * chunk, n1 = min(N, n0 + chunk);
  if (slot < R) {
    float sm[V], sp[V], mm[V], mp[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      sm[j] = sp[j] = 0.f;
      mm[j] = mp[j] = -INFINITY;
    }
    const int64_t row0 = static_cast<int64_t>(b) * N;
    const uint4* mv = reinterpret_cast<const uint4*>(mri) + row0 * L + lane;
    const uint4* pv = reinterpret_cast<const uint4*>(pet) + row0 * L + lane;
    for (int n = n0 + slot; n < n1; n += kUnroll * R) {
      uint4 qm[kUnroll], qp[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int t = n + u * R;
        if (t < n1) {
          qm[u] = mv[static_cast<int64_t>(t) * L];
          qp[u] = pv[static_cast<int64_t>(t) * L];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (n + u * R < n1) {
          add_token<V>(qm[u], sm, mm);
          add_token<V>(qp[u], sp, mp);
        }
      }
    }
    float* dst = part + slot * D + lane * V;
    store<V>(dst, sm);
    store<V>(dst + R * D, sp);
    store<V>(dst + 2 * R * D, mm);
    store<V>(dst + 3 * R * D, mp);
  }
  __syncthreads();
  // the block: slot 0 of each (s, d) takes the sum or max of the R slots,
  // in slot order
  for (int i = threadIdx.x; i < 4 * D; i += kClusterThreads) {
    const int s = i / D, d = i - s * D;
    float* col = part + s * R * D + d;
    float acc = col[0];
#pragma unroll 4
    for (int r = 1; r < R; ++r) {
      acc = s < 2 ? acc + col[r * D] : fmaxf(acc, col[r * D]);
    }
    col[0] = acc;
  }
  cluster.sync();  // every block's result is visible to the cluster
  if (rank == 0) {
    T* o = out + static_cast<int64_t>(b) * 4 * D;
    for (int i = threadIdx.x; i < 4 * D; i += kClusterThreads) {
      const int s = i / D, d = i - s * D;
      const int at = s * R * D + d;
      float peer[kClusterSize];
#pragma unroll
      for (int k = 1; k < kClusterSize; ++k) {
        peer[k] = cluster.map_shared_rank(part, k)[at];
      }
      float acc = part[at];
#pragma unroll
      for (int k = 1; k < kClusterSize; ++k) {
        acc = s < 2 ? acc + peer[k] : fmaxf(acc, peer[k]);
      }
      o[i] = from_f32<T>(s < 2 ? acc / static_cast<float>(N) : acc);
    }
  }
  cluster.sync();  // peers keep their shared memory until rank 0 has read it
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace
}  // namespace transmf

// variant: 0 = "column", 1 = "cluster" (the wrapper's rule, ops/pooling.py).
// "cluster" refuses a D that is not whole 16-byte pieces, more than 256 of
// them, or a pointer that is not 16-byte aligned.
extern "C" int transmf_token_pool(const void* mri, const void* pet, void* out,
                                  int B, int N, int D, int dtype, int variant,
                                  void* stream) {
  using namespace transmf;
  if (B < 1 || N < 1 || D < 1 || (variant != 0 && variant != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  bool refused = false;
  const int rc = dispatch(dtype, [&](auto tag) {
    using T = decltype(tag);
    const auto* m = static_cast<const T*>(mri);
    const auto* p = static_cast<const T*>(pet);
    auto* o = static_cast<T*>(out);
    if (variant == 0) {
      const int blocks = static_cast<int>(
          ceil_div(static_cast<int64_t>(B) * D, kColumnThreads));
      token_pool_kernel<T><<<blocks, kColumnThreads, 0, st>>>(m, p, o, B, N,
                                                               D);
      return;
    }
    constexpr int V = 16 / sizeof(T);
    const int L = D / V;
    if (D % V != 0 || L > kClusterThreads || !aligned16(mri) ||
        !aligned16(pet) || !aligned16(out)) {
      refused = true;
      return;
    }
    const int chunk = static_cast<int>(ceil_div(N, kClusterSize));
    token_pool_cluster_kernel<T><<<dim3(kClusterSize, B), kClusterThreads, 0,
                                   st>>>(m, p, o, N, D, chunk);
  });
  return refused ? static_cast<int>(cudaErrorInvalidValue) : rc;
}
