// Tensor-core and asynchronous-copy primitives for the bfloat16 kernels that
// run their products on `mma.sync.m16n8k16` (K2, K8-K12) and on `wgmma` (K8 at
// the models' widths; its own note below): thin wrappers over the PTX
// instructions, with the fragment layouts they imply written down once.
//
// With g = lane / 4 and t = lane % 4, one m16n8k16 product D += A B holds
//   A (16 x 16, row-major), 4 registers of two bfloat16:
//     a0 = A[g][2t, 2t+1]      a1 = A[g+8][2t, 2t+1]
//     a2 = A[g][2t+8, 2t+9]    a3 = A[g+8][2t+8, 2t+9]
//   B (16 x 8), 2 registers:
//     b0 = B[2t, 2t+1][g]      b1 = B[2t+8, 2t+9][g]
//   C, D (16 x 8), 4 floats:
//     c0, c1 = C[g][2t, 2t+1]  c2, c3 = C[g+8][2t, 2t+1]
// `ldmatrix.x4` reads four 8 x 8 bfloat16 matrices whose eight 16-byte rows
// are addressed by lanes 0-7, 8-15, 16-23 and 24-31; lane l receives, of
// matrix i, the pair [l / 4][2 (l % 4), +1] in register i (or, with .trans,
// the pair [2 (l % 4), +1][l / 4] of the stored matrix). So
//   - an A fragment comes from rows of 16 k-values: lane l addresses row
//     l % 16 at k offset 8 (l / 16);
//   - the B fragments of two neighbouring n-tiles come from memory stored
//     [n][k] (k contiguous) without .trans: lane l addresses n = l % 8 +
//     8 (l / 16) at k offset 8 ((l / 8) % 2), registers (b0, b1, b0', b1');
//   - or from memory stored [k][n] (n contiguous) with .trans: lane l
//     addresses k = l % 8 + 8 ((l / 8) % 2) at n offset 8 (l / 16), the same
//     registers.
// Every row address must be 16-byte aligned; rows whose stride is an odd
// multiple of 16 bytes (or that are XOR-swizzled) load without bank conflicts.
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace transmf {

__device__ __forceinline__ unsigned smem_address(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from device to shared memory, asynchronously; `real` false writes
// 16 zero bytes and reads nothing (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool real) {
  const unsigned bytes = real ? 16u : 0u;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_address(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// 4 bytes, the same way (a float of a row vector whose start need not be
// 16-byte aligned).
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool real) {
  const unsigned bytes = real ? 4u : 0u;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_address(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most kPending of this thread's committed groups are in
// flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_address(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_address(p)));
}

// d += a b: bfloat16 operands, float32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bfloat16 in one register, `lo` in the low half.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// hi = bf16(a, b), lo = bf16(a - hi.a, b - hi.b), packed: a float32 operand
// of a bfloat16 product as two fragments, hi + lo within 2^-17 of it.
__device__ __forceinline__ void split_bf16(float a, float b, unsigned& hi,
                                           unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = pack_bf16(a - hf.x, b - hf.y);
}

// Each lane t of a quad (lanes 4 g .. 4 g + 3) holds its own two channels
// (2 t, 2 t + 1, packed) of four neighbouring 8-channel tiles, v[j] of tile
// j, as the C fragments of four m16n8 products leave them. Returns the eight
// channels of tile t, 16 contiguous bytes: the quad then stores 64 contiguous
// bytes of one voxel. Two rounds of exchanges, with lanes t ^ 1 and t ^ 2.
__device__ __forceinline__ uint4 quad_transpose(const unsigned (&v)[4], int t) {
  constexpr unsigned kAll = 0xffffffffu;
  const bool odd = t & 1, high = t & 2;
  // of tiles (t & 1) and 2 + (t & 1): the pairs of lanes t & ~1 and t | 1
  const unsigned got0 = __shfl_xor_sync(kAll, odd ? v[0] : v[1], 1);
  const unsigned got1 = __shfl_xor_sync(kAll, odd ? v[2] : v[3], 1);
  const unsigned lo0 = odd ? got0 : v[0], lo1 = odd ? v[1] : got0;
  const unsigned hi0 = odd ? got1 : v[2], hi1 = odd ? v[3] : got1;
  // keep the tile this lane ends with, hand the other to lane t ^ 2
  const unsigned far0 = __shfl_xor_sync(kAll, high ? lo0 : hi0, 2);
  const unsigned far1 = __shfl_xor_sync(kAll, high ? lo1 : hi1, 2);
  return high ? make_uint4(far0, far1, hi0, hi1)
              : make_uint4(lo0, lo1, far0, far1);
}

// The same for two neighbouring tiles, u0 and u1 (16 channels): returns
// channels 4 t .. 4 t + 3 of the pair, 8 contiguous bytes, so that the quad
// stores 32 contiguous bytes of one voxel.
__device__ __forceinline__ uint2 pair_transpose(unsigned u0, unsigned u1,
                                                int t) {
  constexpr unsigned kAll = 0xffffffffu;
  // channel pairs 2 (t & 1) and 2 (t & 1) + 1 of tile t >> 1
  const int src = (threadIdx.x & 28) | (2 * (t & 1));
  const unsigned a0 = __shfl_sync(kAll, u0, src);
  const unsigned a1 = __shfl_sync(kAll, u1, src);
  const unsigned b0 = __shfl_sync(kAll, u0, src + 1);
  const unsigned b1 = __shfl_sync(kAll, u1, src + 1);
  return (t >> 1) ? make_uint2(a1, b1) : make_uint2(a0, b0);
}

// --- warpgroup MMA (sm_90a) -------------------------------------------------
//
// wgmma.mma_async.m64nNk16: the four warps of a warpgroup multiply a 64 x 16
// A tile with a 16 x N B tile into a 64 x N float32 accumulator. Here A comes
// from registers: warp w of the warpgroup holds rows 16 w .. 16 w + 15 in the
// m16n8k16 A layout above. B is read by the tensor cores straight from shared
// memory through a 64-bit descriptor; the layout used here is K-major with the
// 128-byte swizzle: row n of a tile holds 64 consecutive k (128 bytes), rows
// are 128 bytes apart, the tile starts on a 1,024-byte boundary, and the
// 16-byte piece c of row n sits at piece c ^ (n % 8). The 16 k of one product
// start 32 j bytes into the rows (j = 0 .. 3). The accumulator of a thread is
// N / 8 groups of 4 floats in the m16n8k16 C layout: d[4 j + e] belongs to
// columns 8 j + 2 t + (e % 2), row g + 8 (e / 2) of the warp's 16 rows.
//
// Protocol: wgmma_fence() after the registers of A or D were written by
// other instructions and before the first wgmma; wgmma_commit() closes a
// group; wgmma_wait<n>() returns when at most n groups are in flight. The
// registers of A and D must not be touched while a group that uses them is in
// flight; keep_alive() after the wait pins A's registers until then. Shared
// memory written by ordinary stores or cp.async needs fence_async_proxy()
// before the tensor cores read it.

__device__ __forceinline__ uint64_t wgmma_desc_k128(const void* p) {
  const uint64_t addr = smem_address(p);
  return ((addr & 0x3ffff) >> 4) | (uint64_t{1} << 16) |
         (uint64_t{1024 >> 4} << 32) | (uint64_t{1} << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void keep_alive(unsigned (&r)[4]) {
  asm volatile("" : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3])::"memory");
}

// d += a b, N = 32 or 64 columns; d has N / 2 floats a thread.
template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2],
                                           const unsigned (&a)[4],
                                           uint64_t b_desc);

template <>
__device__ __forceinline__ void wgmma_bf16<32>(float (&d)[16],
                                               const unsigned (&a)[4],
                                               uint64_t b_desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float (&d)[32],
                                               const unsigned (&a)[4],
                                               uint64_t b_desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(1));
}

}  // namespace transmf
