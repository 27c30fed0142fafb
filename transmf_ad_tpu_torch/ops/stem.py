"""Single-channel 3x3x3 SAME convolution, the sNet stem (eval forward).

Port of `stem_conv` from transmf_ad_tpu/ops/stem.py (kernel K3,
csrc/stem_conv.cu). The training variants (in-kernel BN statistics, the
weight-gradient kernels, the z-blocked full-resolution forms) are still to
port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .._build import INT, PTR, Kernel, check_cuda

STEM_CONV = Kernel(
    name="stem_conv", entry="transmf_stem_conv",
    argtypes=(PTR, PTR, PTR, INT, INT, INT, INT, INT, INT),
    source="transmf_ad_tpu_torch/csrc/stem_conv.cu",
    replaces="transmf_ad_tpu/ops/stem.py:99")

MAX_CHANNELS = 256


def _conv_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (B, X, Y, Z), w: (3, 3, 3, C) -> (B, X, Y, Z, C), no bias."""
    wt = w.permute(3, 0, 1, 2).unsqueeze(1)  # (C, 1, 3, 3, 3), OIDHW
    y = F.conv3d(x.unsqueeze(1), wt, padding=1)  # (B, C, X, Y, Z)
    return y.permute(0, 2, 3, 4, 1).contiguous()


def stem_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Single-channel 3x3x3 SAME conv: (B, X, Y, Z) x (3, 3, 3, C) ->
    (B, X, Y, Z, C), linear (the caller folds bias, BN and activation into
    the stage-end pool). Kernel K3 on CUDA tensors; the plain version on CPU
    tensors."""
    if x.device.type == "cpu":
        return _conv_reference(x, w)
    dtype = check_cuda("stem_conv", x, w)
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, 3):
        raise ValueError(f"stem_conv: shapes x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}; expected (B,X,Y,Z), (3,3,3,C)")
    b, X, Y, Z = x.shape
    c = w.shape[3]
    if c > MAX_CHANNELS or b * X > 65535:
        raise ValueError(f"stem_conv: C={c} (max {MAX_CHANNELS}) or "
                         f"B*X={b * X} (max 65535) out of range")
    out = torch.empty(b, X, Y, Z, c, dtype=x.dtype, device=x.device)
    STEM_CONV.launch(x.device, x.data_ptr(), w.data_ptr(), out.data_ptr(),
                     b, X, Y, Z, c, dtype)
    return out
