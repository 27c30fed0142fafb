#!/usr/bin/env python3
"""What bounds K8 "mma" (the tensor-core band conv of transmf_ad_tpu_torch)?

    python3 ablate_band_conv.py

needs a CUDA GPU and nvcc. The machine has no kernel profiler to ask, so this
script takes the kernel apart instead: it builds copies of csrc/band_conv.cu
with one part of the wgmma kernel's loop over a plane removed by a textual
substitution (the results of such a copy are wrong by design and are not
looked at), and times each at the full-resolution shapes, (6, 91, 109, 91)
with 32 -> 32, 32 -> 64 and 64 -> 32 channels in bfloat16, next to the kernel
as it is:

    as it is         the kernel of the repository
    no A loads       the input fragments are constants: no ldmatrix of the
                     halo; the products and the tensor cores' own reads of the
                     weights remain
    no MMAs          every fragment is loaded and folded into the accumulator
                     with one XOR and one add instead of the tensor cores
    half the stores  the epilogue stores voxels g and not g + 8
    no planes        the cp.async loads of the input planes are skipped
    no products      the products of the taps are skipped: planes, barriers
                     and the epilogue's stores (of zeros) remain

(Skipping all of the epilogue's stores tells nothing: ptxas then drops the
products whose results nobody reads.)

A substitution whose pattern is not in the source raises, so the script
fails when the kernel changes under it. Times are CUDA-event medians of 10
launches after 2; the card's name and power limit are printed first.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from transmf_ad_tpu_torch import _build

LOAD_A = "ldmatrix_x4(ag[j], plane[dx] + (dy * kMHZ + dz) * CS + kc * 16);"
MMA = """wgmma_bf16<kCB>(acc, ag[j],
                          b_desc + (step >> 2) * (kCB * 8) + (step & 3) * 2);"""
PLANE = "cp_async16(dst + vox * CS + c * 8, src, real);"
STEPS = "constexpr int kSteps = 27 * kPerTap;"
STORE = "if (row_ok && gz < Z && co < Cout) {"
CONST_A = "ag[j][0] = ag[j][1] = ag[j][2] = ag[j][3] = 0x3f803f80u + j;"
FOLD = ("acc[j] += __uint_as_float("
        "(ag[j][0] ^ ag[j][1] ^ ag[j][2] ^ ag[j][3]) >> 9);")
VARIANTS = {
    "as it is": {},
    "no A loads": {LOAD_A: CONST_A},
    "no MMAs": {MMA: FOLD},
    "half the stores": {STORE: STORE.replace(") {", " && h == 0) {")},
    "no planes": {PLANE: ""},
    "no products": {STEPS: "constexpr int kSteps = 0;"},
}
SHAPES = ((32, 32), (32, 64), (64, 32))
BATCH, VOLUME = 6, (91, 109, 91)


def build_variant(tmp: Path, name: str, edits: dict) -> ctypes.CDLL:
    src = (_build.CSRC_DIR / "band_conv.cu").read_text()
    for old, new in edits.items():
        if old not in src:
            raise RuntimeError(f"{name}: pattern not found: {old}")
        src = src.replace(old, new)
    for header in _build.CSRC_DIR.glob("*.cuh"):
        (tmp / header.name).write_text(header.read_text())
    cu = tmp / (name.replace(" ", "_") + ".cu")
    cu.write_text(src)
    so = cu.with_suffix(".so")
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS[:-2], "-shared",
                    "-o", str(so), str(cu)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.transmf_band_conv.argtypes = [ctypes.c_void_p] * 5 + \
        [ctypes.c_int] * 9 + [ctypes.c_void_p]
    lib.transmf_band_conv.restype = ctypes.c_int
    return lib


def time_ms(lib, x, w, out) -> float:
    b, X, Y, Z, cin = x.shape
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        err = lib.transmf_band_conv(x.data_ptr(), w.data_ptr(),
                                    out.data_ptr(), None, None, b, X, Y, Z,
                                    cin, w.shape[-1], 0, 1, 1, stream)
        if err:
            raise RuntimeError(f"launch failed: {err}")

    for _ in range(2):
        launch()
    times = []
    for _ in range(10):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        launch()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def main() -> int:
    if not torch.cuda.is_available():
        print("ablate_band_conv: needs a CUDA GPU", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    data = {}
    for cin, cout in SHAPES:
        x = torch.randn(BATCH, *VOLUME, cin, generator=g, device="cuda")
        w = torch.randn(3, 3, 3, cin, cout, generator=g, device="cuda")
        data[cin, cout] = (x.bfloat16(), (w * (13.5 * cin) ** -0.5).bfloat16(),
                           torch.empty(BATCH, *VOLUME, cout, device="cuda",
                                       dtype=torch.bfloat16))
    with tempfile.TemporaryDirectory() as tmp:
        for name, edits in VARIANTS.items():
            lib = build_variant(Path(tmp), name, edits)
            row = ", ".join(
                f"{cin}->{cout} {time_ms(lib, *data[cin, cout]):.4f}"
                for cin, cout in SHAPES)
            print(f"[K8 mma, {name}] ms: {row}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
