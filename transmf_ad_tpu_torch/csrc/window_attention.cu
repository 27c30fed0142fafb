// K14: shifted-window attention with a relative position bias, MONAI's
// WindowAttention as SwinTransformerBlock.forward_part1 runs it, forward and
// backward, on a token-ordered (B, X, Y, Z) grid (ops/window_attention.py).
//
// Addressing. Window wi of the B * windows (MONAI's order: sample, then x,
// y, z windows of the padded grid) and its row i (the window's x, y, z
// order) sit at p = window origin + (i's offsets) in the padded grid after
// the roll by -shift; the token there is o = (p + shift) mod padded, a real
// token where o lies inside the grid, else one the zero pad added. A real
// token's q, k and v are read from its row of qkv (channels (3, heads, 16)),
// a padded token's from qkv_bias (the projection of a zero vector): it is a
// live key, as in MONAI. Outputs go back to the real tokens' rows, so the
// pad, roll, partition, reverse and crop are never materialised. The bias
// of score (i, j) is table[A(i) - A(j) + c, h]: MONAI's relative position
// index of the FULL window, A(i) = (x (2 W1 - 1) + y) (2 W2 - 1) + z with
// (x, y, z) = i's coordinates in the full window, which is MONAI's
// index[:n, :n] also for a window clamped to a small grid. Where any shift
// is non-zero, -100 is added between tokens of different regions of the
// padded grid (compute_mask: per axis, p < P - w, p < P - s, the rest; an
// axis without shift is one region). Each block keeps its head's table
// column and the window's row map (token, A, region) in shared memory.
//
// "mma" (bfloat16; attention_mma.cuh and flash_bwd_mma.cuh's fragments):
// - forward: one block a (window, head). The window's Q, K and V rows, up
//   to 512, land in shared memory (cp.async, rows padded by 16 bytes, rows
//   past n zero); each warp takes 16-row query tiles in turn and streams the
//   keys in chunks of 64 as K2's body does (S on mma.sync; scale, bias and
//   mask folded into one FMA in the log2 domain, the table held times
//   log2(e); the online softmax; P as hi + lo bfloat16 fragments into P V).
//   The mask is skipped in a window whose rows all lie in one region. O
//   goes to the real tokens' rows, the natural-log logsumexp of every row
//   to lse (B * windows, heads, n). Padded query rows are computed and not
//   stored, as MONAI crops them.
// - backward, kernel 1: one block a (group of windows, head). Per window Q,
//   K, V, g land in shared memory and delta = rowsum(g * o) is taken per
//   row (and kept for kernel 2); phase 1, a warp a query tile, recomputes S
//   and dP = g V^T a chunk of 64 keys, P = exp(S - lse), dS = P (dP -
//   delta) (K11's arithmetic) and dQ += dS K; phase 2, a warp a key tile,
//   recomputes S^T and dP^T a chunk of 64 queries and accumulates dV += P^T
//   g and dK += dS^T Q (K12's). dQ, dK, dV go to the real tokens' rows of
//   dqkv, each written once; a padded key's dK and dV are summed in
//   registers over the block's windows. A padded query row (g = 0) and a
//   row past n read lse = +inf, so its P is 0.
// - backward, kernel 2 (the table): G[i][j] = the sum over windows of
//   dS[i][j], one block a (group, head, 128 query rows, 64 keys) whose warps
//   keep their 16 x 64 sums in registers across the group's windows (no
//   atomics: shared-memory float atomics compile to a compare-and-swap loop
//   on sm_90, which cost 18-19 ms of a 44-50 ms backward at stage 1); it
//   recomputes S and dP for its piece, kGBatch windows a round of copies.
//   One thread an entry of the table then adds G over the (i, j) whose
//   offset the entry is and over the groups, in a fixed order: d table (T,
//   heads); reduce_rows adds the padded keys' sums, (heads, 32) float32.
// "rows" (float32): the same blocks on the CUDA cores, one thread a row:
//   the forward's online softmax over the window's keys; the backward's
//   phase 1 a thread a query row (its dS added to the table's sums with
//   shared-memory atomics), phase 2 a thread a key row.
#include <algorithm>

#include "flash_bwd_mma.cuh"

namespace transmf {
namespace {

constexpr int kWinD = 16;                // head width
constexpr int kWinRS = kWinD + kRowPad;  // bfloat16 row stride, 48 bytes
constexpr int kWinWarps = 8;
constexpr int kWinThreads = kWinWarps * 32;
constexpr int kWinMaxRows = 512;  // a window's tokens, rounded up to 64
constexpr float kMaskValue = -100.f;

struct WinGeo {
  int B, X, Y, Z;
  int w0, w1, w2;  // the window, clamped to the grid
  int s0, s1, s2;  // the shift
  int W0, W1, W2;  // the full window, for the index
  int heads;
  int P0, P1, P2;  // the padded grid
  int n1, n2;      // windows along y and z
  int nw;          // windows a sample
  int n;           // tokens a window
  int npad;        // n rounded up to 64
  int T;           // table rows
  int tpad;        // T rounded up to 4: the table's floats in shared memory
  int cidx;        // the index's offset: A of the full window's last token
  int C;           // channels, heads * 16
  int mask;        // any shift
};

// 0, 1 or 2: the region of padded coordinate p along an axis (P padded, w
// window, s shift), as compute_mask's slices assign it; 0 without shift.
__device__ __forceinline__ int axis_region(int p, int P, int w, int s) {
  if (s == 0) return 0;
  return p < P - w ? 0 : (p < P - s ? 1 : 2);
}

// A window's sample and the padded (rolled) coordinates of its first
// token, from its index in MONAI's order; `next_window` steps to the next.
struct WinOrigin {
  int b, x, y, z;
};

__device__ __forceinline__ WinOrigin window_origin(const WinGeo& g, int wi) {
  const int w = wi % g.nw;
  return {wi / g.nw, w / (g.n1 * g.n2) * g.w0, (w / g.n2) % g.n1 * g.w1,
          w % g.n2 * g.w2};
}

__device__ __forceinline__ void next_window(const WinGeo& g, WinOrigin& o) {
  if ((o.z += g.w2) < g.P2) return;
  o.z = 0;
  if ((o.y += g.w1) < g.P1) return;
  o.y = 0;
  if ((o.x += g.w0) < g.P0) return;
  o.x = 0;
  ++o.b;
}

// The token (or -1 for a padded one) and the region of the row at offsets
// (ix, iy, iz) in the window at o.
__device__ __forceinline__ void row_at(const WinGeo& g, const WinOrigin& o,
                                       int ix, int iy, int iz, int& tok,
                                       int& reg) {
  const int px = o.x + ix, py = o.y + iy, pz = o.z + iz;
  reg = (axis_region(px, g.P0, g.w0, g.s0) * 3 +
         axis_region(py, g.P1, g.w1, g.s1)) * 3 +
        axis_region(pz, g.P2, g.w2, g.s2);
  int ox = px + g.s0, oy = py + g.s1, oz = pz + g.s2;
  if (ox >= g.P0) ox -= g.P0;
  if (oy >= g.P1) oy -= g.P1;
  if (oz >= g.P2) oz -= g.P2;
  tok = (ox < g.X && oy < g.Y && oz < g.Z)
            ? ((o.b * g.X + ox) * g.Y + oy) * g.Z + oz
            : -1;
}

// A(i): row i's relative position coordinate in the full window.
__device__ __forceinline__ int full_a(const WinGeo& g, int i) {
  const int fx = i / (g.W1 * g.W2), fy = (i / g.W2) % g.W1, fz = i % g.W2;
  return (fx * (2 * g.W1 - 1) + fy) * (2 * g.W2 - 1) + fz;
}

// Row i (< n) of window wi: the real token's index (or -1 for a padded
// token), A(i) and the region.
__device__ __forceinline__ void row_info(const WinGeo& g, int wi, int i,
                                         int& tok, int& a, int& reg) {
  row_at(g, window_origin(g, wi), i / (g.w1 * g.w2), (i / g.w2) % g.w1,
         i % g.w2, tok, reg);
  a = full_a(g, i);
}

constexpr int kNoRegion = 31;  // the region field of a row past n

// The row map of window wi into shared memory: each row's token (-1 past
// n) and its A and region packed as A << 5 | region (a row past n: A 0,
// an in-range table row, and kNoRegion). Ends in a barrier; returns
// whether the shift mask acts in this window (its rows lie in more than
// one region), the same in every thread.
__device__ __forceinline__ bool load_row_map(const WinGeo& g, int wi,
                                             int* tok_s, int* info_s) {
  int tok0, a0, reg0;
  row_info(g, wi, 0, tok0, a0, reg0);
  int mixed = 0;
  for (int i = threadIdx.x; i < g.npad; i += blockDim.x) {
    int tok = -1, a = 0, reg = kNoRegion;
    if (i < g.n) {
      row_info(g, wi, i, tok, a, reg);
      mixed |= reg != reg0;
    }
    tok_s[i] = tok;
    info_s[i] = a << 5 | reg;
  }
  const bool any = __syncthreads_or(mixed);  // every thread, always
  return g.mask && any;
}

// A 16-row x 64-column chunk of raw scores (C fragments) to the log2
// domain in place: s * c + table[index] * log2(e) (tab2 holds the head's
// table times log2(e)), and -100 * log2(e) between regions where `masked`.
// info0, info1: the packed A and region of the thread's rows (g, g + 8);
// info: the chunk's columns'. kT: rows are keys and columns queries (the
// transposed products of the key phase), so the index is A(col) - A(row).
constexpr float kMaskLog2 = kMaskValue * kLog2e;

template <bool kT>
__device__ __forceinline__ void to_log2(float (&s)[8][4], const float* tab2,
                                        int cidx, int info0, int info1,
                                        const int* info, int t, float c,
                                        bool masked) {
  const int r0 = info0 & 31, r1 = info1 & 31;
  const float* b0 = tab2 + cidx + (kT ? -(info0 >> 5) : info0 >> 5);
  const float* b1 = tab2 + cidx + (kT ? -(info1 >> 5) : info1 >> 5);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int v = info[j * 8 + 2 * t + h];
      const int ac = kT ? v >> 5 : -(v >> 5);
      float x0 = b0[ac], x1 = b1[ac];
      if (masked) {
        const int rc = v & 31;
        x0 += rc != r0 ? kMaskLog2 : 0.f;
        x1 += rc != r1 ? kMaskLog2 : 0.f;
      }
      s[j][h] = fmaf(s[j][h], c, x0);
      s[j][2 + h] = fmaf(s[j][2 + h], c, x1);
    }
  }
}

// Element offset of head h's 16 channels of part (0 q, 1 k, 2 v) in a qkv
// row of token `tok`, or in qkv_bias for a padded token.
__device__ __forceinline__ int64_t qkv_offset(const WinGeo& g, int tok,
                                              int part, int h) {
  const int64_t in_row = static_cast<int64_t>(part) * g.C + h * kWinD;
  return tok >= 0 ? static_cast<int64_t>(tok) * 3 * g.C + in_row : in_row;
}

// ---- "mma" ---------------------------------------------------------------

// The A fragments (KD = 1) of rows r0 and r0 + 8 of a [rows][kWinRS] chunk.
__device__ __forceinline__ void load_a_smem(unsigned (&a)[1][4],
                                            const __nv_bfloat16* s, int r0,
                                            int t) {
  const unsigned* p0 =
      reinterpret_cast<const unsigned*>(s + r0 * kWinRS + 2 * t);
  const unsigned* p1 =
      reinterpret_cast<const unsigned*>(s + (r0 + 8) * kWinRS + 2 * t);
  a[0][0] = p0[0];
  a[0][1] = p1[0];
  a[0][2] = p0[4];
  a[0][3] = p1[4];
}

// Starts the copy of the window's rows of the parts in `parts` (bit p: part
// p of qkv into dst[p]; bit 3: g into dst[3]) into [npad][kWinRS] shared
// chunks; rows past n arrive as zeros, a padded token's qkv from qkv_bias
// and its g as zeros. The caller commits.
__device__ __forceinline__ void copy_window(
    const WinGeo& g, const int* tok_s, int h, const __nv_bfloat16* qkv,
    const __nv_bfloat16* bias, const __nv_bfloat16* gout, int parts,
    __nv_bfloat16* const (&dst)[4]) {
  for (int idx = threadIdx.x; idx < g.npad * 8; idx += blockDim.x) {
    const int part = (idx >> 1) & 3, r = idx >> 3, piece = idx & 1;
    if (!((parts >> part) & 1)) continue;
    const int tok = tok_s[r];
    const __nv_bfloat16* src;
    bool real = r < g.n;
    if (part < 3) {
      src = (tok >= 0 ? qkv : bias) + qkv_offset(g, tok, part, h);
    } else {
      real = real && tok >= 0;
      src = gout + (tok >= 0 ? static_cast<int64_t>(tok) * g.C : 0) +
            h * kWinD;
    }
    cp_async16(dst[part] + r * kWinRS + piece * 8, src + piece * 8, real);
  }
}

// The head's table times log2(e) into shared memory (tab2).
__device__ __forceinline__ void load_table_log2(const WinGeo& g,
                                                const float* table, int h,
                                                float* tab2) {
  for (int i = threadIdx.x; i < g.T; i += blockDim.x) {
    tab2[i] = table[static_cast<int64_t>(i) * g.heads + h] * kLog2e;
  }
}

__global__ void __launch_bounds__(kWinThreads)
    window_fwd_mma_kernel(const __nv_bfloat16* __restrict__ qkv,
                          const __nv_bfloat16* __restrict__ bias,
                          const float* __restrict__ table,
                          __nv_bfloat16* __restrict__ out,
                          float* __restrict__ lse, const WinGeo g,
                          float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + g.npad * kWinRS;
  __nv_bfloat16* vs = ks + g.npad * kWinRS;
  float* tab2 = reinterpret_cast<float*>(vs + g.npad * kWinRS);
  int* tok_s = reinterpret_cast<int*>(tab2 + g.tpad);
  int* info_s = tok_s + g.npad;

  const int h = blockIdx.x % g.heads, wi = blockIdx.x / g.heads;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane / 4, t = lane % 4;
  load_table_log2(g, table, h, tab2);
  const bool masked = load_row_map(g, wi, tok_s, info_s);
  __nv_bfloat16* const dst[4] = {qs, ks, vs, nullptr};
  copy_window(g, tok_s, h, qkv, bias, nullptr, 7, dst);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int k_lane = lane_nk(lane, kWinRS), v_lane = lane_kn(lane, kWinRS);
  const int tiles = (g.n + 15) / 16, chunks = g.npad / kChunk;
  const float c = scale * kLog2e;
  for (int qt = warp; qt < tiles; qt += kWinWarps) {
    const int r0 = qt * 16 + gr, r1 = r0 + 8;
    unsigned qa[1][4];
    load_a_smem(qa, qs, r0, t);
    const int info0 = info_s[r0], info1 = info_s[r1];
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    float acc[2][4] = {};
    for (int ch = 0; ch < chunks; ++ch) {
      float s[8][4];
      scores<1>(s, qa, ks + ch * kChunk * kWinRS, k_lane);
      to_log2<false>(s, tab2, g.cidx, info0, info1, info_s + ch * kChunk, t,
                     c, masked);
      if (ch == chunks - 1) {  // the keys past n
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (ch * kChunk + j * 8 + 2 * t + (e & 1) >= g.n) {
              s[j][e] = -INFINITY;
            }
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
      // every chunk holds a key < n, so the new maxima are finite
      const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
      const float alpha0 = exp2f(m0 - n0), alpha1 = exp2f(m1 - n1);
      m0 = n0;
      m1 = n1;
      l0 *= alpha0;
      l1 *= alpha1;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
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
      accumulate_split<1>(acc, s, vs + ch * kChunk * kWinRS, v_lane);
    }
    l0 += __shfl_xor_sync(kMmaFull, l0, 1);
    l0 += __shfl_xor_sync(kMmaFull, l0, 2);
    l1 += __shfl_xor_sync(kMmaFull, l1, 1);
    l1 += __shfl_xor_sync(kMmaFull, l1, 2);
    float* row_lse = lse + (static_cast<int64_t>(wi) * g.heads + h) * g.n;
    if (t == 0) {
      if (r0 < g.n) row_lse[r0] = (m0 + log2f(l0)) * kLn2;
      if (r1 < g.n) row_lse[r1] = (m1 + log2f(l1)) * kLn2;
    }
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    const int tk0 = r0 < g.n ? tok_s[r0] : -1;
    const int tk1 = r1 < g.n ? tok_s[r1] : -1;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = h * kWinD + j * 8 + 2 * t;
      if (tk0 >= 0) {
        *reinterpret_cast<unsigned*>(out + static_cast<int64_t>(tk0) * g.C +
                                     col) =
            pack_bf16(acc[j][0] * inv0, acc[j][1] * inv0);
      }
      if (tk1 >= 0) {
        *reinterpret_cast<unsigned*>(out + static_cast<int64_t>(tk1) * g.C +
                                     col) =
            pack_bf16(acc[j][2] * inv1, acc[j][3] * inv1);
      }
    }
  }
}

// Stores rows r0 and r0 + 8 (C fragments of 16 rows x 16 columns, times
// `factor`) of part `part` of dqkv where the row is a real token; adds them
// to `pad` (the thread's 4 columns) where it is a padded one (pad may be
// null: nothing is added).
__device__ __forceinline__ void store_part(const WinGeo& g, const int* tok_s,
                                           __nv_bfloat16* dqkv,
                                           const float (&acc)[2][4], int r0,
                                           int t, int part, int h,
                                           float factor, float* pad) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    if (r >= g.n) continue;
    const int tok = tok_s[r];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float x = acc[j][2 * half] * factor, y = acc[j][2 * half + 1] *
                                                     factor;
      if (tok >= 0) {
        *reinterpret_cast<unsigned*>(dqkv + qkv_offset(g, tok, part, h) +
                                     j * 8 + 2 * t) = pack_bf16(x, y);
      } else if (pad != nullptr) {
        pad[2 * j] += x;
        pad[2 * j + 1] += y;
      }
    }
  }
}

// The padded keys' sums of a block: the thread's 4 columns (8 j + 2 t, + 1)
// of dk (kb) and dv (vb), summed over the warp's lanes with the same t, then
// over the warps in order, into 32 floats (16 dk, 16 dv) of `part`.
__device__ __forceinline__ void write_pad_sums(float (&kb)[4], float (&vb)[4],
                                               float* red, float* part) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int sh = 4; sh < 32; sh *= 2) {
      kb[i] += __shfl_xor_sync(kMmaFull, kb[i], sh);
      vb[i] += __shfl_xor_sync(kMmaFull, vb[i], sh);
    }
  }
  if (gr == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = (i / 2) * 8 + 2 * t + (i % 2);
      red[warp * 32 + col] = kb[i];
      red[warp * 32 + kWinD + col] = vb[i];
    }
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    float sum = 0.f;
    for (int w = 0; w < static_cast<int>(blockDim.x) / 32; ++w) {
      sum += red[w * 32 + threadIdx.x];
    }
    part[threadIdx.x] = sum;
  }
}

__global__ void __launch_bounds__(kWinThreads, 2)
    window_bwd_mma_kernel(const __nv_bfloat16* __restrict__ qkv,
                          const __nv_bfloat16* __restrict__ bias,
                          const float* __restrict__ table,
                          const __nv_bfloat16* __restrict__ out,
                          const float* __restrict__ lse,
                          const __nv_bfloat16* __restrict__ gout,
                          __nv_bfloat16* __restrict__ dqkv,
                          float* __restrict__ delta, float* __restrict__ part_bias,
                          const WinGeo g, int per_group, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + g.npad * kWinRS;
  __nv_bfloat16* vs = ks + g.npad * kWinRS;
  __nv_bfloat16* gs = vs + g.npad * kWinRS;
  float* tab2 = reinterpret_cast<float*>(gs + g.npad * kWinRS);
  float* lse_s = tab2 + g.tpad;
  float* dl_s = lse_s + g.npad;
  float* red = dl_s + g.npad;
  int* tok_s = reinterpret_cast<int*>(red + kWinWarps * 32);
  int* info_s = tok_s + g.npad;

  const int h = blockIdx.x % g.heads, grp = blockIdx.x / g.heads;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane / 4, t = lane % 4;
  load_table_log2(g, table, h, tab2);
  const int total = g.B * g.nw;
  const int w_begin = grp * per_group;
  const int w_end = min(total, w_begin + per_group);
  const int b_lane = lane_nk(lane, kWinRS), bt_lane = lane_kn(lane, kWinRS);
  const int tiles = (g.n + 15) / 16, chunks = g.npad / kChunk;
  const float c = scale * kLog2e;
  float kb[4] = {}, vb[4] = {};
  __nv_bfloat16* const dst[4] = {qs, ks, vs, gs};

  for (int wi = w_begin; wi < w_end; ++wi) {
    __syncthreads();  // the previous window's shared rows are read
    const bool masked = load_row_map(g, wi, tok_s, info_s);
    copy_window(g, tok_s, h, qkv, bias, gout, 15, dst);
    cp_async_commit();
    const int64_t row0 = (static_cast<int64_t>(wi) * g.heads + h) * g.n;
    for (int i = threadIdx.x; i < g.npad; i += blockDim.x) {
      lse_s[i] = i < g.n && tok_s[i] >= 0 ? lse[row0 + i] * kLog2e : INFINITY;
    }
    cp_async_wait<0>();
    __syncthreads();
    for (int i = threadIdx.x; i < g.npad; i += blockDim.x) {
      float d = 0.f;
      const int tok = i < g.n ? tok_s[i] : -1;
      if (tok >= 0) {  // 16 channels: two 16-byte loads of each row
        const uint4* o = reinterpret_cast<const uint4*>(
            out + static_cast<int64_t>(tok) * g.C + h * kWinD);
        const uint4* gr4 = reinterpret_cast<const uint4*>(gs + i * kWinRS);
        const uint4 ov[2] = {o[0], o[1]}, gv[2] = {gr4[0], gr4[1]};
        const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(ov);
        const __nv_bfloat162* gp = reinterpret_cast<const __nv_bfloat162*>(gv);
#pragma unroll
        for (int k = 0; k < kWinD / 2; ++k) {
          const float2 a = __bfloat1622float2(op[k]);
          const float2 b = __bfloat1622float2(gp[k]);
          d += a.x * b.x + a.y * b.y;
        }
      }
      dl_s[i] = d;
      if (i < g.n) delta[row0 + i] = d;
    }
    __syncthreads();

    // phase 1: dQ, a warp a query tile
    for (int qt = warp; qt < tiles; qt += kWinWarps) {
      const int r0 = qt * 16 + gr, r1 = r0 + 8;
      unsigned qa[1][4], ga[1][4];
      load_a_smem(qa, qs, r0, t);
      load_a_smem(ga, gs, r0, t);
      const float l0 = lse_s[r0], l1 = lse_s[r1];
      const float d0 = dl_s[r0], d1 = dl_s[r1];
      const int info0 = info_s[r0], info1 = info_s[r1];
      float acc[2][4] = {};
      for (int ch = 0; ch < chunks; ++ch) {
        const __nv_bfloat16* kb_s = ks + ch * kChunk * kWinRS;
        float s[8][4], dp[8][4];
        scores<1>(s, qa, kb_s, b_lane);
        scores<1>(dp, ga, vs + ch * kChunk * kWinRS, b_lane);
        to_log2<false>(s, tab2, g.cidx, info0, info1, info_s + ch * kChunk,
                       t, c, masked);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool top = e < 2;
            p_ds_pair(s[j][e], dp[j][e], 1.f, top ? l0 : l1, top ? d0 : d1,
                      ch * kChunk + j * 8 + 2 * t + (e & 1) < g.n);
          }
        }
        accumulate_split<1>(acc, dp, kb_s, bt_lane);  // dQ += dS K
      }
      store_part(g, tok_s, dqkv, acc, r0, t, 0, h, scale, nullptr);
    }

    // phase 2: dK and dV, a warp a key tile
    for (int kt = warp; kt < tiles; kt += kWinWarps) {
      const int r0 = kt * 16 + gr, r1 = r0 + 8;
      unsigned ka[1][4], va[1][4];
      load_a_smem(ka, ks, r0, t);
      load_a_smem(va, vs, r0, t);
      const int info0 = info_s[r0], info1 = info_s[r1];
      float acc_k[2][4] = {}, acc_v[2][4] = {};
      for (int ch = 0; ch < chunks; ++ch) {
        const __nv_bfloat16* qb = qs + ch * kChunk * kWinRS;
        const __nv_bfloat16* gb = gs + ch * kChunk * kWinRS;
        float st[8][4], dpt[8][4];
        scores<1>(st, ka, qb, b_lane);   // S^T = K Q^T
        scores<1>(dpt, va, gb, b_lane);  // dP^T = V g^T
        to_log2<true>(st, tab2, g.cidx, info0, info1, info_s + ch * kChunk, t,
                      c, masked);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = ch * kChunk + j * 8 + 2 * t;
          const float2 lc = *reinterpret_cast<const float2*>(lse_s + col);
          const float2 dc = *reinterpret_cast<const float2*>(dl_s + col);
          p_ds_pair(st[j][0], dpt[j][0], 1.f, lc.x, dc.x, col < g.n);
          p_ds_pair(st[j][1], dpt[j][1], 1.f, lc.y, dc.y, col + 1 < g.n);
          p_ds_pair(st[j][2], dpt[j][2], 1.f, lc.x, dc.x, col < g.n);
          p_ds_pair(st[j][3], dpt[j][3], 1.f, lc.y, dc.y, col + 1 < g.n);
        }
        accumulate_split<1>(acc_v, st, gb, bt_lane);   // dV += P^T g
        accumulate_split<1>(acc_k, dpt, qb, bt_lane);  // dK += dS^T Q
      }
      store_part(g, tok_s, dqkv, acc_k, r0, t, 1, h, scale, kb);
      store_part(g, tok_s, dqkv, acc_v, r0, t, 2, h, 1.f, vb);
    }
  }
  __syncthreads();
  write_pad_sums(kb, vb, red,
                 part_bias + (static_cast<int64_t>(grp) * g.heads + h) * 32);
}

// The table's gradient, summed over windows without atomics: G[i][j] = the
// sum over the group's windows of dS[i][j], a block a (group, head, 128
// query rows, 64 keys), a warp a 16-row query tile whose (16 x 64) sums stay
// in its registers for the whole group. The block takes kGBatch windows at
// a time: their row maps, then their rows of Q and g and their keys' K and
// V in one round of copies, then each warp recomputes S and dP = g V^T for
// each window in turn (K11's arithmetic, from the logsumexp and the delta
// the backward kernel left) and adds dS. Each block writes its 128 x 64
// piece of G as its group's partial: (groups, heads, gpad, npad), gpad the
// query rows rounded up to 128.
constexpr int kGRows = kWinWarps * 16;
constexpr int kGBatch = 4;
constexpr int kGMap = kGRows + kChunk;  // rows a window's map holds

// One window's slot in the table kernel's shared memory.
struct GSlot {
  __nv_bfloat16 q[kGRows * kWinRS], g[kGRows * kWinRS];
  __nv_bfloat16 k[kChunk * kWinRS], v[kChunk * kWinRS];
  float lse[kGRows], dl[kGRows];
  int tok[kGMap], info[kGMap];  // the block's rows, then its keys
};

__global__ void __launch_bounds__(kWinThreads, 2)
    window_table_grad_mma_kernel(const __nv_bfloat16* __restrict__ qkv,
                                 const __nv_bfloat16* __restrict__ bias,
                                 const float* __restrict__ table,
                                 const float* __restrict__ lse,
                                 const float* __restrict__ delta,
                                 const __nv_bfloat16* __restrict__ gout,
                                 float* __restrict__ part_g, const WinGeo g,
                                 int per_group, int row_groups, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  GSlot* slots = reinterpret_cast<GSlot*>(smem_raw);
  float* tab2 = reinterpret_cast<float*>(slots + kGBatch);
  unsigned* reg_or = reinterpret_cast<unsigned*>(tab2 + g.tpad);
  unsigned* reg_and = reg_or + kWinWarps * kGBatch;

  const int chunks = g.npad / kChunk;
  int idx = blockIdx.x;
  const int kc = idx % chunks;
  idx /= chunks;
  const int rg = idx % row_groups;
  idx /= row_groups;
  const int h = idx % g.heads, grp = idx / g.heads;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane / 4, t = lane % 4;
  const int row0 = rg * kGRows, col0 = kc * kChunk;
  const bool live = (rg * kWinWarps + warp) * 16 < g.n;  // warp-uniform
  load_table_log2(g, table, h, tab2);
  const int total = g.B * g.nw;
  const int w_begin = grp * per_group;
  const int w_end = min(total, w_begin + per_group);
  const int b_lane = lane_nk(lane, kWinRS);
  const float c = scale * kLog2e;
  float acc[8][4] = {};
  // this thread's row of every window's map (the block's rows, then its
  // keys): its offsets in the window and its A, the same in every window
  const int map_k = threadIdx.x;
  const int map_r = map_k < kGRows ? row0 + map_k : col0 + map_k - kGRows;
  const bool mapped = map_k < kGMap && map_r < g.n;
  const int ix = mapped ? map_r / (g.w1 * g.w2) : 0;
  const int iy = mapped ? (map_r / g.w2) % g.w1 : 0;
  const int iz = mapped ? map_r % g.w2 : 0;
  const int map_a = mapped ? full_a(g, map_r) : 0;

  for (int wb = w_begin; wb < w_end; wb += kGBatch) {
    const int nb = min(kGBatch, w_end - wb);
    __syncthreads();  // the previous batch's shared rows are read
    unsigned r_or[kGBatch] = {}, r_and[kGBatch];
    WinOrigin o = window_origin(g, wb);
#pragma unroll
    for (int b = 0; b < kGBatch; ++b) {
      r_and[b] = ~0u;
      if (b < nb && map_k < kGMap) {
        int tok = -1, reg = kNoRegion;
        if (mapped) {
          row_at(g, o, ix, iy, iz, tok, reg);
          r_or[b] |= 1u << reg;
          r_and[b] &= 1u << reg;
        }
        slots[b].tok[map_k] = tok;
        slots[b].info[map_k] = map_a << 5 | reg;
      }
      next_window(g, o);
    }
#pragma unroll
    for (int b = 0; b < kGBatch; ++b) {
      const unsigned o = __reduce_or_sync(kMmaFull, r_or[b]);
      const unsigned n = __reduce_and_sync(kMmaFull, r_and[b]);
      if (lane == 0) {
        reg_or[warp * kGBatch + b] = o;
        reg_and[warp * kGBatch + b] = n;
      }
    }
    __syncthreads();
    // Q and g of the block's rows, K and V of its keys, 16-byte pieces
    for (int i = threadIdx.x; i < nb * kGMap * 4; i += blockDim.x) {
      GSlot& sl = slots[i / (kGMap * 4)];
      const int k = (i / 4) % kGMap, second = (i >> 1) & 1, piece = i & 1;
      const bool row = k < kGRows;
      const int rr = row ? k : k - kGRows;
      const int tok = sl.tok[k];
      const int pos = (row ? row0 : col0) + rr;
      const __nv_bfloat16* src;
      bool real = pos < g.n;
      if (row && second) {  // g: zero for a padded token
        real = real && tok >= 0;
        src = gout + (tok >= 0 ? static_cast<int64_t>(tok) * g.C : 0) +
              h * kWinD;
      } else {
        const int part = row ? 0 : 1 + second;
        src = (tok >= 0 ? qkv : bias) + qkv_offset(g, tok, part, h);
      }
      __nv_bfloat16* d = row ? (second ? sl.g : sl.q) : (second ? sl.v : sl.k);
      cp_async16(d + rr * kWinRS + piece * 8, src + piece * 8, real);
    }
    cp_async_commit();
    for (int i = threadIdx.x; i < nb * kGRows; i += blockDim.x) {
      GSlot& sl = slots[i / kGRows];
      const int k = i % kGRows;
      const int64_t wrow =
          (static_cast<int64_t>(wb + i / kGRows) * g.heads + h) * g.n;
      const bool valid = row0 + k < g.n && sl.tok[k] >= 0;
      sl.lse[k] = valid ? lse[wrow + row0 + k] * kLog2e : INFINITY;
      sl.dl[k] = valid ? delta[wrow + row0 + k] : 0.f;
    }
    cp_async_wait<0>();
    __syncthreads();
    if (!live) continue;
    const int lr0 = warp * 16 + gr, lr1 = lr0 + 8;
#pragma unroll
    for (int b = 0; b < kGBatch; ++b) {
      if (b >= nb) break;
      const GSlot& sl = slots[b];
      unsigned ro = 0, ra = ~0u;
      for (int w = 0; w < kWinWarps; ++w) {
        ro |= reg_or[w * kGBatch + b];
        ra &= reg_and[w * kGBatch + b];
      }
      const bool masked = g.mask && ro != ra;  // more than one region
      unsigned qa[1][4], ga[1][4];
      load_a_smem(qa, sl.q, lr0, t);
      load_a_smem(ga, sl.g, lr0, t);
      float s[8][4], dp[8][4];
      scores<1>(s, qa, sl.k, b_lane);
      scores<1>(dp, ga, sl.v, b_lane);
      to_log2<false>(s, tab2, g.cidx, sl.info[lr0], sl.info[lr1],
                     sl.info + kGRows, t, c, masked);
      const float l0 = sl.lse[lr0], l1 = sl.lse[lr1];
      const float d0 = sl.dl[lr0], d1 = sl.dl[lr1];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool top = e < 2;
          p_ds_pair(s[j][e], dp[j][e], 1.f, top ? l0 : l1, top ? d0 : d1,
                    col0 + j * 8 + 2 * t + (e & 1) < g.n);
          acc[j][e] += dp[j][e];
        }
      }
    }
  }
  const int gpad = row_groups * kGRows;
  float* dst = part_g + (static_cast<int64_t>(grp) * g.heads + h) * gpad *
                            g.npad;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = col0 + j * 8 + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row0 + warp * 16 + gr + 8 * half;
      *reinterpret_cast<float2*>(dst + static_cast<int64_t>(r) * g.npad +
                                 col) =
          make_float2(acc[j][2 * half], acc[j][2 * half + 1]);
    }
  }
}

// d table (T, heads) from G's partials (groups, heads, gpad, npad): entry t
// of head h adds G[i][j] over the pairs whose full-window coordinates
// differ by t's offset and over the groups, j by j, the groups in order.
// One thread an entry.
__global__ void window_table_scatter_kernel(const float* __restrict__ part_g,
                                            float* __restrict__ dtable,
                                            const WinGeo g, int gpad,
                                            int groups) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= g.T * g.heads) return;
  const int t = idx / g.heads, h = idx % g.heads;
  const int q2 = 2 * g.W2 - 1, q1 = 2 * g.W1 - 1;
  const int dz = t % q2 - (g.W2 - 1), dy = (t / q2) % q1 - (g.W1 - 1);
  const int dx = t / (q1 * q2) - (g.W0 - 1);
  const int64_t per_group = static_cast<int64_t>(g.heads) * gpad * g.npad;
  const float* gh = part_g + static_cast<int64_t>(h) * gpad * g.npad;
  float sum = 0.f;
  for (int j = 0; j < g.n; ++j) {
    const int x = j / (g.W1 * g.W2) + dx, y = (j / g.W2) % g.W1 + dy;
    const int z = j % g.W2 + dz;
    if (x < 0 || x >= g.W0 || y < 0 || y >= g.W1 || z < 0 || z >= g.W2) {
      continue;
    }
    const int i = (x * g.W1 + y) * g.W2 + z;
    if (i >= g.n) continue;
    const float* at = gh + static_cast<int64_t>(i) * g.npad + j;
    for (int b = 0; b < groups; ++b) sum += at[b * per_group];
  }
  dtable[idx] = sum;
}

// ---- "rows" (float32) ------------------------------------------------------

// The bias and mask of score (row, col) in the natural log domain.
__device__ __forceinline__ float score_bias(const WinGeo& g, const float* tab,
                                            int info_row, int info_col,
                                            bool masked) {
  float b = tab[(info_row >> 5) - (info_col >> 5) + g.cidx];
  if (masked && (info_row & 31) != (info_col & 31)) b += kMaskValue;
  return b;
}

// Row r's 16 values of part `part` (q, k, v from qkv or qkv_bias; 3: g, zero
// for a padded token).
__device__ __forceinline__ void load_row_f32(const WinGeo& g, int tok,
                                             int part, int h, const float* qkv,
                                             const float* bias,
                                             const float* gout, float* dst) {
  const float* src;
  if (part < 3) {
    src = (tok >= 0 ? qkv : bias) + qkv_offset(g, tok, part, h);
  } else if (tok >= 0) {
    src = gout + static_cast<int64_t>(tok) * g.C + h * kWinD;
  } else {
    for (int k = 0; k < kWinD; ++k) dst[k] = 0.f;
    return;
  }
  for (int k = 0; k < kWinD; ++k) dst[k] = src[k];
}

__device__ __forceinline__ float dot16(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < kWinD; ++k) s += a[k] * b[k];
  return s;
}

__global__ void __launch_bounds__(kWinThreads)
    window_fwd_rows_kernel(const float* __restrict__ qkv,
                           const float* __restrict__ bias,
                           const float* __restrict__ table,
                           float* __restrict__ out, float* __restrict__ lse,
                           const WinGeo g, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);
  float* vs = ks + g.npad * kWinD;
  float* tab = vs + g.npad * kWinD;
  int* tok_s = reinterpret_cast<int*>(tab + g.tpad);
  int* info_s = tok_s + g.npad;
  const int h = blockIdx.x % g.heads, wi = blockIdx.x / g.heads;
  for (int i = threadIdx.x; i < g.T; i += blockDim.x) {
    tab[i] = table[static_cast<int64_t>(i) * g.heads + h];
  }
  const bool masked = load_row_map(g, wi, tok_s, info_s);
  for (int j = threadIdx.x; j < g.n; j += blockDim.x) {
    load_row_f32(g, tok_s[j], 1, h, qkv, bias, nullptr, ks + j * kWinD);
    load_row_f32(g, tok_s[j], 2, h, qkv, bias, nullptr, vs + j * kWinD);
  }
  __syncthreads();
  for (int r = threadIdx.x; r < g.n; r += blockDim.x) {
    float q[kWinD], acc[kWinD] = {};
    load_row_f32(g, tok_s[r], 0, h, qkv, bias, nullptr, q);
    float m = -INFINITY, l = 0.f;
    for (int j = 0; j < g.n; ++j) {
      const float s = dot16(q, ks + j * kWinD) * scale +
                      score_bias(g, tab, info_s[r], info_s[j], masked);
      if (s > m) {
        const float corr = expf(m - s);
        l *= corr;
        for (int k = 0; k < kWinD; ++k) acc[k] *= corr;
        m = s;
      }
      const float p = expf(s - m);
      l += p;
      for (int k = 0; k < kWinD; ++k) acc[k] += p * vs[j * kWinD + k];
    }
    lse[(static_cast<int64_t>(wi) * g.heads + h) * g.n + r] = m + logf(l);
    const int tok = tok_s[r];
    if (tok >= 0) {
      float* o = out + static_cast<int64_t>(tok) * g.C + h * kWinD;
      for (int k = 0; k < kWinD; ++k) o[k] = acc[k] / l;
    }
  }
}

// The float32 backward, a block a (group of windows, head): phase 1 a
// thread a query row (dQ, and each dS added to its table entry in shared
// memory with atomicAdd: this variant serves float32 checks, where the
// order of those sums does not matter), phase 2 a thread a key row.
__global__ void __launch_bounds__(kWinThreads)
    window_bwd_rows_kernel(const float* __restrict__ qkv,
                           const float* __restrict__ bias,
                           const float* __restrict__ table,
                           const float* __restrict__ out,
                           const float* __restrict__ lse,
                           const float* __restrict__ gout,
                           float* __restrict__ dqkv,
                           float* __restrict__ part_table,
                           float* __restrict__ part_bias, const WinGeo g,
                           int per_group, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* ks = qs + g.npad * kWinD;
  float* vs = ks + g.npad * kWinD;
  float* gs = vs + g.npad * kWinD;
  float* tab = gs + g.npad * kWinD;
  float* dtab = tab + g.tpad;
  float* lse_s = dtab + g.tpad;
  float* dl_s = lse_s + g.npad;
  float* red = dl_s + g.npad;
  int* tok_s = reinterpret_cast<int*>(red + kWinWarps * 32);
  int* info_s = tok_s + g.npad;

  const int h = blockIdx.x % g.heads, grp = blockIdx.x / g.heads;
  for (int i = threadIdx.x; i < g.T; i += blockDim.x) {
    tab[i] = table[static_cast<int64_t>(i) * g.heads + h];
    dtab[i] = 0.f;
  }
  const int total = g.B * g.nw;
  const int w_begin = grp * per_group;
  const int w_end = min(total, w_begin + per_group);
  float kpad[kWinD] = {}, vpad[kWinD] = {};
  for (int wi = w_begin; wi < w_end; ++wi) {
    __syncthreads();
    const bool masked = load_row_map(g, wi, tok_s, info_s);
    const float* wl = lse + (static_cast<int64_t>(wi) * g.heads + h) * g.n;
    for (int i = threadIdx.x; i < g.n; i += blockDim.x) {
      const int tok = tok_s[i];
      float* const rows[4] = {qs, ks, vs, gs};
      for (int part = 0; part < 4; ++part) {
        load_row_f32(g, tok, part, h, qkv, bias, gout,
                     rows[part] + i * kWinD);
      }
      lse_s[i] = tok >= 0 ? wl[i] : INFINITY;
      dl_s[i] = tok >= 0 ? dot16(out + static_cast<int64_t>(tok) * g.C +
                                     h * kWinD,
                                 gs + i * kWinD)
                         : 0.f;
    }
    __syncthreads();
    // phase 1: a thread a query row
    for (int r = threadIdx.x; r < g.n; r += blockDim.x) {
      const int tok = tok_s[r];
      if (tok < 0) continue;  // g = 0: nothing flows from a padded row
      float dq[kWinD] = {};
      for (int j = 0; j < g.n; ++j) {
        const float s = dot16(qs + r * kWinD, ks + j * kWinD) * scale +
                        score_bias(g, tab, info_s[r], info_s[j], masked);
        const float p = expf(s - lse_s[r]);
        const float ds = p * (dot16(gs + r * kWinD, vs + j * kWinD) -
                              dl_s[r]);
        for (int k = 0; k < kWinD; ++k) dq[k] += ds * ks[j * kWinD + k];
        atomicAdd(dtab + (info_s[r] >> 5) - (info_s[j] >> 5) + g.cidx, ds);
      }
      float* d = dqkv + qkv_offset(g, tok, 0, h);
      for (int k = 0; k < kWinD; ++k) d[k] = dq[k] * scale;
    }
    // phase 2: a thread a key row
    for (int j = threadIdx.x; j < g.n; j += blockDim.x) {
      float dk[kWinD] = {}, dv[kWinD] = {};
      for (int r = 0; r < g.n; ++r) {
        if (tok_s[r] < 0) continue;
        const float s = dot16(qs + r * kWinD, ks + j * kWinD) * scale +
                        score_bias(g, tab, info_s[r], info_s[j], masked);
        const float p = expf(s - lse_s[r]);
        const float ds = p * (dot16(gs + r * kWinD, vs + j * kWinD) -
                              dl_s[r]);
        for (int k = 0; k < kWinD; ++k) {
          dk[k] += ds * qs[r * kWinD + k];
          dv[k] += p * gs[r * kWinD + k];
        }
      }
      const int tok = tok_s[j];
      if (tok >= 0) {
        float* d = dqkv + qkv_offset(g, tok, 1, h);
        for (int k = 0; k < kWinD; ++k) d[k] = dk[k] * scale;
        d = dqkv + qkv_offset(g, tok, 2, h);
        for (int k = 0; k < kWinD; ++k) d[k] = dv[k];
      } else {
        for (int k = 0; k < kWinD; ++k) {
          kpad[k] += dk[k] * scale;
          vpad[k] += dv[k];
        }
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < g.T; i += blockDim.x) {
    part_table[(static_cast<int64_t>(grp) * g.T + i) * g.heads + h] = dtab[i];
  }
  // the padded keys' sums: over each warp's lanes, then the warps in order
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int k = 0; k < 2 * kWinD; ++k) {
    float v = k < kWinD ? kpad[k] : vpad[k - kWinD];
    for (int sh = 16; sh > 0; sh /= 2) v += __shfl_xor_sync(kMmaFull, v, sh);
    if (lane == 0) red[warp * 32 + k] = v;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    float sum = 0.f;
    for (int w = 0; w < kWinWarps; ++w) sum += red[w * 32 + threadIdx.x];
    part_bias[(static_cast<int64_t>(grp) * g.heads + h) * 32 + threadIdx.x] =
        sum;
  }
}

// The geometry from the entries' integers; false where it is not one the
// kernels take.
bool make_geo(WinGeo& g, int B, int X, int Y, int Z, int w0, int w1, int w2,
              int s0, int s1, int s2, int W0, int W1, int W2, int heads) {
  g = WinGeo{B, X, Y, Z, w0, w1, w2, s0, s1, s2, W0, W1, W2, heads};
  if (B < 1 || X < 1 || Y < 1 || Z < 1 || heads < 1 || w0 < 1 || w1 < 1 ||
      w2 < 1 || w0 > W0 || w1 > W1 || w2 > W2 || s0 < 0 || s1 < 0 ||
      s2 < 0 || s0 >= w0 || s1 >= w1 || s2 >= w2) {
    return false;
  }
  g.P0 = static_cast<int>(ceil_div(X, w0)) * w0;
  g.P1 = static_cast<int>(ceil_div(Y, w1)) * w1;
  g.P2 = static_cast<int>(ceil_div(Z, w2)) * w2;
  g.n1 = g.P1 / w1;
  g.n2 = g.P2 / w2;
  g.nw = (g.P0 / w0) * g.n1 * g.n2;
  g.n = w0 * w1 * w2;
  g.npad = static_cast<int>(ceil_div(g.n, kChunk)) * kChunk;
  g.T = (2 * W0 - 1) * (2 * W1 - 1) * (2 * W2 - 1);
  g.tpad = (g.T + 3) / 4 * 4;
  g.cidx = ((W0 - 1) * (2 * W1 - 1) + (W1 - 1)) * (2 * W2 - 1) + (W2 - 1);
  g.C = heads * kWinD;
  g.mask = (s0 > 0 || s1 > 0 || s2 > 0) ? 1 : 0;
  const int64_t tokens = static_cast<int64_t>(B) * X * Y * Z;
  const int64_t blocks = static_cast<int64_t>(B) * g.nw * heads;
  return g.npad <= kWinMaxRows && tokens * 3 * g.C < (int64_t{1} << 31) &&
         blocks <= 0x7fffffff;
}

size_t fwd_smem(const WinGeo& g, bool mma) {
  const size_t rows = mma ? sizeof(__nv_bfloat16) * 3 * g.npad * kWinRS
                          : sizeof(float) * 2 * g.npad * kWinD;
  return rows + sizeof(float) * g.tpad + sizeof(int) * 2 * g.npad;
}

size_t bwd_smem(const WinGeo& g, bool mma) {
  const size_t rows = mma ? sizeof(__nv_bfloat16) * 4 * g.npad * kWinRS
                          : sizeof(float) * 4 * g.npad * kWinD;
  return rows + sizeof(float) * ((mma ? 1 : 2) * g.tpad + 2 * g.npad +
                                 kWinWarps * 32) +
         sizeof(int) * 2 * g.npad;
}

size_t table_grad_smem(const WinGeo& g) {
  return sizeof(GSlot) * kGBatch + sizeof(float) * g.tpad +
         sizeof(unsigned) * 2 * kWinWarps * kGBatch;
}

// Blocks a backward launch aims at: 8 for each of the H100's 132 SMs.
constexpr int kBwdBlocks = 8 * 132;

// The backward's split of the windows: (groups, windows a group) for a
// block a (group, head) ...
int bwd_groups(const WinGeo& g) {
  const int total = g.B * g.nw;
  return static_cast<int>(
      std::max<int64_t>(1, std::min<int64_t>(total, ceil_div(kBwdBlocks,
                                                             g.heads))));
}

// ... and for the table's kernel, a block a (group, head, 128 query rows,
// 64 keys).
int table_row_groups(const WinGeo& g) {
  return static_cast<int>(ceil_div(g.n, kGRows));
}

int table_groups(const WinGeo& g) {
  const int64_t per = static_cast<int64_t>(g.heads) * table_row_groups(g) *
                      (g.npad / kChunk);
  return static_cast<int>(std::max<int64_t>(
      1, std::min<int64_t>(g.B * g.nw, ceil_div(kBwdBlocks, per))));
}

// The backward's float32 work space, in order: "mma": delta (B * windows,
// heads, n), the padded keys' partial sums (groups, heads, 32) and G's
// partials (table groups, heads, gpad, npad);
// "rows": the table's partials (groups, T, heads) and the padded keys'.
struct BwdWork {
  int64_t delta, part_bias, part_g, part_table, total;
};

BwdWork bwd_work(const WinGeo& g, bool mma) {
  // each piece starts on 16 bytes (the table's kernel stores float2)
  const auto up4 = [](int64_t x) { return (x + 3) / 4 * 4; };
  BwdWork w{};
  const int64_t groups = bwd_groups(g);
  const int64_t gpad = static_cast<int64_t>(table_row_groups(g)) * kGRows;
  const int64_t gh = static_cast<int64_t>(g.heads) * gpad * g.npad;
  int64_t at = 0;
  if (mma) {
    w.delta = at;
    at = up4(at + static_cast<int64_t>(g.B) * g.nw * g.heads * g.n);
  } else {
    w.part_table = at;
    at = up4(at + groups * g.T * g.heads);
  }
  w.part_bias = at;
  at = up4(at + groups * g.heads * 32);
  if (mma) {
    w.part_g = at;
    at += table_groups(g) * gh;
  }
  w.total = at;
  return w;
}

}  // namespace
}  // namespace transmf

// qkv (B, X, Y, Z, 3 * heads * 16) and qkv_bias (3C,) of one dtype (variant
// 1 "mma": bfloat16; 0 "rows": float32), 16-byte aligned; table (T, heads)
// float32. out (B, X, Y, Z, C) in qkv's dtype, lse (B * windows, heads, n)
// float32. One block a (window, head).
extern "C" int transmf_window_attention_fwd(
    const void* qkv, const void* bias, const void* table, void* out,
    void* lse, int B, int X, int Y, int Z, int w0, int w1, int w2, int s0,
    int s1, int s2, int W0, int W1, int W2, int heads, float scale, int dtype,
    int variant, void* stream) {
  using namespace transmf;
  WinGeo g;
  const bool mma = variant == 1;
  if (!make_geo(g, B, X, Y, Z, w0, w1, w2, s0, s1, s2, W0, W1, W2, heads) ||
      (variant != 0 && variant != 1) ||
      dtype != (mma ? kBFloat16 : kFloat32) || !aligned16(qkv) ||
      !aligned16(bias) || !aligned16(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const size_t smem = fwd_smem(g, mma);
  const auto blocks = static_cast<unsigned>(static_cast<int64_t>(B) * g.nw *
                                            heads);
  const auto* tab = static_cast<const float*>(table);
  if (mma) {
    using T = __nv_bfloat16;
    const cudaError_t e = allow_smem(window_fwd_mma_kernel, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    window_fwd_mma_kernel<<<blocks, kWinThreads, smem, st>>>(
        static_cast<const T*>(qkv), static_cast<const T*>(bias), tab,
        static_cast<T*>(out), static_cast<float*>(lse), g, scale);
  } else {
    const cudaError_t e = allow_smem(window_fwd_rows_kernel, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    window_fwd_rows_kernel<<<blocks, kWinThreads, smem, st>>>(
        static_cast<const float*>(qkv), static_cast<const float*>(bias), tab,
        static_cast<float*>(out), static_cast<float*>(lse), g, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

// The float32 words of work space transmf_window_attention_bwd needs for
// this geometry and variant; -1 for a geometry the kernels do not take.
extern "C" long long transmf_window_attention_bwd_work(
    int B, int X, int Y, int Z, int w0, int w1, int w2, int s0, int s1,
    int s2, int W0, int W1, int W2, int heads, int variant) {
  using namespace transmf;
  WinGeo g;
  if (!make_geo(g, B, X, Y, Z, w0, w1, w2, s0, s1, s2, W0, W1, W2, heads)) {
    return -1;
  }
  return bwd_work(g, variant == 1).total;
}

// The backward of transmf_window_attention_fwd for the output gradient g
// (like out): dqkv like qkv; `work` of transmf_window_attention_bwd_work's
// size; dtable (T, heads) and kv_bias (heads, 32: each head's dk then dv
// sums over the padded keys) float32. "mma": the backward kernel (dq, dk,
// dv, delta, the padded keys' partials), the table's kernel (G's partials),
// the scatter into the table over G's groups. "rows": one kernel, then
// reduce_rows.
extern "C" int transmf_window_attention_bwd(
    const void* qkv, const void* bias, const void* table, const void* out,
    const void* lse, const void* gout, void* dqkv, void* work, void* dtable,
    void* kv_bias, int B, int X, int Y, int Z, int w0, int w1, int w2, int s0,
    int s1, int s2, int W0, int W1, int W2, int heads, float scale,
    int dtype, int variant, void* stream) {
  using namespace transmf;
  WinGeo g;
  const bool mma = variant == 1;
  if (!make_geo(g, B, X, Y, Z, w0, w1, w2, s0, s1, s2, W0, W1, W2, heads) ||
      (variant != 0 && variant != 1) ||
      dtype != (mma ? kBFloat16 : kFloat32) || !aligned16(qkv) ||
      !aligned16(bias) || !aligned16(out) || !aligned16(gout) ||
      !aligned16(dqkv) || !aligned16(work)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const BwdWork w = bwd_work(g, mma);
  float* ws = static_cast<float*>(work);
  const int groups = bwd_groups(g);
  const int per_group = static_cast<int>(ceil_div(B * g.nw, groups));
  const auto blocks = static_cast<unsigned>(groups * heads);
  const auto* tab = static_cast<const float*>(table);
  const auto* ls = static_cast<const float*>(lse);
  const size_t smem = bwd_smem(g, mma);
  cudaError_t e;
  if (mma) {
    using T = __nv_bfloat16;
    e = allow_smem(window_bwd_mma_kernel, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    window_bwd_mma_kernel<<<blocks, kWinThreads, smem, st>>>(
        static_cast<const T*>(qkv), static_cast<const T*>(bias), tab,
        static_cast<const T*>(out), ls, static_cast<const T*>(gout),
        static_cast<T*>(dqkv), ws + w.delta, ws + w.part_bias, g, per_group,
        scale);
    const int tgroups = table_groups(g), row_groups = table_row_groups(g);
    const int gpad = row_groups * kGRows;
    const size_t tsmem = table_grad_smem(g);
    e = allow_smem(window_table_grad_mma_kernel, tsmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    window_table_grad_mma_kernel<<<static_cast<unsigned>(
                                       tgroups * heads * row_groups *
                                       (g.npad / kChunk)),
                                   kWinThreads, tsmem, st>>>(
        static_cast<const T*>(qkv), static_cast<const T*>(bias), tab, ls,
        ws + w.delta, static_cast<const T*>(gout), ws + w.part_g, g,
        static_cast<int>(ceil_div(B * g.nw, tgroups)), row_groups, scale);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    window_table_scatter_kernel<<<static_cast<unsigned>(
                                      ceil_div(g.T * heads, 256)),
                                  256, 0, st>>>(
        ws + w.part_g, static_cast<float*>(dtable), g, gpad, tgroups);
  } else {
    e = allow_smem(window_bwd_rows_kernel, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    window_bwd_rows_kernel<<<blocks, kWinThreads, smem, st>>>(
        static_cast<const float*>(qkv), static_cast<const float*>(bias), tab,
        static_cast<const float*>(out), ls, static_cast<const float*>(gout),
        static_cast<float*>(dqkv), ws + w.part_table, ws + w.part_bias, g,
        per_group, scale);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    reduce_rows(ws + w.part_table, static_cast<float*>(dtable), groups,
                g.T * heads, 1, st);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  reduce_rows(ws + w.part_bias, static_cast<float*>(kv_bias), groups,
              heads * 32, 1, st);
  return static_cast<int>(cudaGetLastError());
}
