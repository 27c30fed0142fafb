#!/usr/bin/env python3
"""How fast the card can write K3 / K5 "mma"'s output, against the kernels.

    python3 probe_stem_stores.py

At the full-resolution stem shape, (6, 182, 218, 182) -> 32 channels in
bfloat16 (2.77 GB written), on one CUDA device: CUDA-event medians of

- `Tensor.fill_` on the output, the card's rate for one sequential write;
- a store-only kernel (built here with nvcc, no loads, no barriers) that
  writes the output in the order K3 / K5 "mma" do: blocks of 256 threads,
  each a column of 32 x 16 (y, z) voxel tiles over the kernels' segments
  along x, one 16-byte piece a lane, a tile row's 1 KB at its place in the
  volume ("tile rows"), and again with each block's plane written as one
  contiguous 32 KB run ("contiguous runs");
- K3 "mma" (`stem_conv`) and K5 "mma" (`stem_conv_stats`) on the same shape;

each beside the byte bound of the write (3.35 TB/s). The store-only kernel
says what the tile order costs the memory system; the gap between it and
the kernels is the kernels' own work per plane (halo builds, barriers,
products). Prints the card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

SHAPE, C = (6, 182, 218, 182), 32
TILE_Y, TILE_Z = 32, 16  # K3 / K5 "mma"'s (y, z) tile
HBM_RATE = 3.35e12

SOURCE = r"""
#include <cuda_runtime.h>
#include <cstdint>
// Blocks as K3 / K5 "mma" cut the volume: (b, seg, yt, zt), each marching
// over its segment's planes; warp w writes tile rows w, w + 8, ... of a
// plane, lane l 16 bytes. contiguous = 0: each row's 1 KB at its place in
// (B, X, Y, Z, 32); 1: the block's plane as one run.
__global__ void __launch_bounds__(256) tile_stores(
    uint4* out, int B, int X, int Y, int Z, int ty, int nyt, int nzt,
    int segs, int seg_len, int contiguous) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t row = blockIdx.x;
  const int64_t total = static_cast<int64_t>(B) * X * Y * Z * 4;
  const uint4 v = make_uint4(1u, 2u, 3u, 4u);
  const int zt = static_cast<int>(row % nzt);
  const int yt = static_cast<int>((row / nzt) % nyt);
  const int64_t sb = row / (static_cast<int64_t>(nzt) * nyt);
  const int xs = static_cast<int>(sb % segs) * seg_len;
  const int xe = min(X, xs + seg_len);
  const int64_t b = sb / segs;
  const int y0 = yt * ty, z0 = zt * 16;
  for (int xx = xs; xx < xe; ++xx) {
    for (int r = warp; r < ty && y0 + r < Y; r += 8) {
      for (int k = 0; k < 2; ++k) {
        const int e = lane + 32 * k;  // 16-byte piece of the row's 1 KB
        int64_t at;
        if (contiguous) {
          at = ((row * seg_len + (xx - xs)) * ty + r) * 64 + e;
        } else {
          if (z0 + e / 4 >= Z) continue;
          at = (((b * X + xx) * Y + y0 + r) * static_cast<int64_t>(Z) + z0)
               * 4 + e;
        }
        if (at < total) __stcs(out + at, v);
      }
    }
  }
}
extern "C" int run(void* out, int B, int X, int Y, int Z, int ty, int segs,
                   int contiguous, void* stream) {
  const int nyt = (Y + ty - 1) / ty, nzt = (Z + 15) / 16;
  const int seg_len = (X + segs - 1) / segs;
  const unsigned blocks = B * nyt * nzt * ((X + seg_len - 1) / seg_len);
  tile_stores<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(out), B, X, Y, Z, ty, nyt, nzt,
      (X + seg_len - 1) / seg_len, seg_len, contiguous);
  return static_cast<int>(cudaGetLastError());
}
"""


def _median_ms(fn, iters=15):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def _probe_library():
    """The store-only kernel, built with nvcc beside the port's library."""
    from transmf_ad_tpu_torch import _build

    out_dir = _build.BUILD_DIR / "probe_stem_stores"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "tile_stores.cu"
    src.write_text(SOURCE)
    lib = out_dir / "tile_stores.so"
    subprocess.run([_build.find_nvcc(), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", str(lib), str(src)],
                   check=True)
    fn = ctypes.CDLL(str(lib)).run
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_stem_stores: needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    from transmf_ad_tpu_torch.ops import stem

    b, X, Y, Z = SHAPE
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(b, X, Y, Z, generator=g, device="cuda").bfloat16()
    w = (0.2 * torch.randn(3, 3, 3, C, generator=g, device="cuda")).bfloat16()
    out = torch.empty(b, X, Y, Z, C, dtype=torch.bfloat16, device="cuda")
    # the kernels' own segments: K5 writes one row of partials a block
    columns = b * -(-Y // TILE_Y) * -(-Z // TILE_Z)
    segs = stem._blocks_fn()(b, X, Y, Z, 1) // columns
    run = _probe_library()
    stream = torch.cuda.current_stream().cuda_stream

    def probe(contiguous):
        err = run(out.data_ptr(), b, X, Y, Z, TILE_Y, segs, contiguous,
                  stream)
        if err:
            raise RuntimeError(f"tile_stores: launch failed ({err})")

    bound = 1e3 * out.numel() * out.element_size() / HBM_RATE
    rows = [("fill_", lambda: out.fill_(1.0)),
            ("store-only, tile rows", lambda: probe(0)),
            ("store-only, contiguous runs", lambda: probe(1)),
            ('K3 "mma" (stem_conv)', lambda: stem.stem_conv(x, w)),
            ('K5 "mma" (stem_conv_stats)',
             lambda: stem.stem_conv_stats(x, w))]
    print(f"{SHAPE} -> {C} bfloat16, {segs} segments along x; bound of the "
          f"write {bound:.4f} ms at 3.35 TB/s", flush=True)
    for name, fn in rows:
        ms = _median_ms(fn)
        print(f"{name}: {ms:.4f} ms, {bound / ms:.0%} of the bound",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
