#!/usr/bin/env python3
"""What bounds K8 "mma" and K9 "mma" (the tensor-core band conv of
transmf_ad_tpu_torch and its weight gradient)?

    python3 ablate_band_conv.py [band_conv] [band_dw]

(both when none is named)
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

K9 "mma" the same way, at (6, 91, 109, 91) with 32 x 32 and 32 x 64
channels, with a, b2 and without:

    as it is         the kernel of the repository
    no A loads       the halo's fragments are constants: no ldmatrix of x
    no MMAs          the fragments folded into the sums by XOR and add
    no yhat          with a, b2: gy and y arrive, yhat is not assembled
    no copies        no cp.async of the halo, gy or y (the buffers keep what
                     they hold)
    one group of 9 warps  16 output channels a block, not 2 x 16
    8-row tiles      voxel tiles of 8 x 16, not 16 x 16

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

DW_MMA = """mma_bf16(acc[dy][mi][2 * nb], af, bw[dy][nb][0], bw[dy][nb][1]);
              mma_bf16(acc[dy][mi][2 * nb + 1], af, bw[dy][nb][2],
                       bw[dy][nb][3]);"""
DW_FOLD = ("acc[dy][mi][2 * nb][0] += __uint_as_float((af[0] ^ bw[dy][nb][0] "
           "^ bw[dy][nb][1]) >> 9); acc[dy][mi][2 * nb + 1][0] += "
           "__uint_as_float((af[1] ^ bw[dy][nb][2] ^ bw[dy][nb][3]) >> 9);")
DW_LOAD_A = "ldmatrix_x4_trans(af, ha + r * kDHZ * CS + mi * 16);"
DW_CONST_A = "af[0] = af[1] = af[2] = af[3] = 0x3f803f80u + mi + r;"
DW_COPIES = ("cp_async16(slot + vox * CS + c * 8, src, real);",
             "cp_async16(hy + vox * YS + c * 8, gy + off, real);",
             "if (with_ab) cp_async16(hr + vox * YS + c * 8, y + off, real);")
DW_VARIANTS = {
    "as it is": {},
    "no A loads": {DW_LOAD_A: DW_CONST_A},
    "no MMAs": {DW_MMA: DW_FOLD},
    "no yhat": {"      assemble(buf);\n": ""},
    "no copies": dict.fromkeys(DW_COPIES, ""),
    "one group of 9 warps": {"p.wn = Cout > 16 * p.nb ? 2 : 1;":
                             "p.wn = 1;"},
    "8-row tiles": {"constexpr int kDY = 16;": "constexpr int kDY = 8;"},
}
DW_SHAPES = ((32, 32, True), (32, 64, True), (32, 64, False))


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
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS[:-2],
                           "-shared", "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{name}: build failed:\n{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.transmf_band_conv.argtypes = [ctypes.c_void_p] * 5 + \
        [ctypes.c_int] * 9 + [ctypes.c_void_p]
    lib.transmf_band_conv.restype = ctypes.c_int
    lib.transmf_band_dw.argtypes = [ctypes.c_void_p] * 7 + \
        [ctypes.c_int] * 9 + [ctypes.c_void_p]
    lib.transmf_band_dw.restype = ctypes.c_int
    lib.transmf_band_dw_rows.argtypes = [ctypes.c_int] * 7
    lib.transmf_band_dw_rows.restype = ctypes.c_int64
    return lib


def median_ms(launch) -> float:
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


def checked(err):
    if err:
        raise RuntimeError(f"launch failed: {err}")


def time_ms(lib, x, w, out) -> float:
    b, X, Y, Z, cin = x.shape
    stream = torch.cuda.current_stream().cuda_stream
    return median_ms(lambda: checked(lib.transmf_band_conv(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), None, None, b, X, Y, Z,
        cin, w.shape[-1], 0, 1, 1, stream)))


def time_dw_ms(lib, x, gy, y, a, b2, dw, with_ab) -> float:
    b, X, Y, Z, cin = x.shape
    cout = gy.shape[-1]
    rows = lib.transmf_band_dw_rows(b, X, Y, Z, cin, cout, 1)
    part = torch.empty(rows, 27 * cin * cout, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    return median_ms(lambda: checked(lib.transmf_band_dw(
        x.data_ptr(), y.data_ptr(), gy.data_ptr(), a.data_ptr(),
        b2.data_ptr(), part.data_ptr(), dw.data_ptr(), b, X, Y, Z, cin, cout,
        int(with_ab), 1, 1, stream)))


def ablate_band_conv(g, tmp):
    data = {}
    for cin, cout in SHAPES:
        x = torch.randn(BATCH, *VOLUME, cin, generator=g, device="cuda")
        w = torch.randn(3, 3, 3, cin, cout, generator=g, device="cuda")
        data[cin, cout] = (x.bfloat16(), (w * (13.5 * cin) ** -0.5).bfloat16(),
                           torch.empty(BATCH, *VOLUME, cout, device="cuda",
                                       dtype=torch.bfloat16))
    for name, edits in VARIANTS.items():
        lib = build_variant(tmp, name, edits)
        row = ", ".join(
            f"{cin}->{cout} {time_ms(lib, *data[cin, cout]):.4f}"
            for cin, cout in SHAPES)
        print(f"[K8 mma, {name}] ms: {row}", flush=True)


def ablate_band_dw(g, tmp):
    x = torch.randn(BATCH, *VOLUME, 32, generator=g, device="cuda").bfloat16()
    data = {}
    for cout in (32, 64):
        gy, y = (torch.randn(BATCH, *VOLUME, cout, generator=g,
                             device="cuda").bfloat16() for _ in range(2))
        a, b2 = (torch.randn(cout, generator=g, device="cuda")
                 for _ in range(2))
        dw = torch.empty(3, 3, 3, 32, cout, device="cuda")
        data[cout] = (x, gy, y, a, b2, dw)
    for name, edits in DW_VARIANTS.items():
        lib = build_variant(tmp, "dw " + name, edits)
        row = ", ".join(
            f"32x{cout}{' with a, b2' if ab else ''} "
            f"{time_dw_ms(lib, *data[cout], ab):.4f}"
            for cin, cout, ab in DW_SHAPES)
        print(f"[K9 mma, {name}] ms: {row}", flush=True)


def main(argv=None) -> int:
    which = (argv if argv is not None else sys.argv[1:]) or \
        ["band_conv", "band_dw"]
    if not torch.cuda.is_available():
        print("ablate_band_conv: needs a CUDA GPU", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        if "band_conv" in which:
            ablate_band_conv(g, Path(tmp))
        if "band_dw" in which:
            ablate_band_dw(g, Path(tmp))
    return 0


if __name__ == "__main__":
    sys.exit(main())
