"""2x2x2 stride-2 pooling with a fused affine + LeakyReLU prologue.

Port of the forward passes of transmf_ad_tpu/ops/pool3d.py. The JAX package
keeps two layouts of one piece of math for the TPU (the merged
(B, X, Y, Z*C) view with (Z*C,) lane vectors, and the conv-native view with
(C,) vectors); on the card both are one channels-last kernel, K4
(csrc/pool3d.cu), which reads the affine through a z-stride. Plain pooling
is the same kernel with an identity affine. Backward passes are still to
port.

All entries take and return channels-last (B, X, Y, Z, C) tensors; odd
tails are dropped (floor semantics, torch MaxPool3d(2, 2)).
"""

from __future__ import annotations

import torch

from .._build import FLOAT, INT, PTR, Kernel, check_cuda

AFFINE_ACT_POOL = Kernel(
    name="affine_act_pool", entry="transmf_affine_act_pool",
    argtypes=(PTR, PTR, PTR, PTR, INT, INT, INT, INT, INT, INT, FLOAT, INT,
              INT),
    source="transmf_ad_tpu_torch/csrc/pool3d.cu",
    replaces="transmf_ad_tpu/ops/pool3d.py:484")

_MODES = {"max": 0, "avg": 1}


def affine_act_pool_reference(y, scale, shift, slope: float, mode: str):
    """pool(round(leaky(y * s + b))) in plain PyTorch. scale/shift are f32
    (C,) vectors or (Z*C,) lane vectors; the activation is rounded to y's
    dtype before the max or the float32 mean."""
    b, X, Y, Z, C = y.shape
    # (C,) -> (1, C) and (Z*C,) -> (Z, C) both broadcast over (..., Z, C)
    z = y.float() * scale.reshape(-1, C) + shift.reshape(-1, C)
    z = torch.where(z >= 0, z, slope * z).to(y.dtype)
    Xp, Yp, Zp = X // 2, Y // 2, Z // 2
    win = z[:, :2 * Xp, :2 * Yp, :2 * Zp].reshape(b, Xp, 2, Yp, 2, Zp, 2, C)
    if mode == "max":
        return win.amax(dim=(2, 4, 6))
    return (win.float().sum(dim=(2, 4, 6)) * 0.125).to(y.dtype)


def _affine_act_pool(name, y, scale, shift, slope, mode, lanes):
    if y.device.type == "cpu":
        return affine_act_pool_reference(y, scale, shift, slope, mode)
    dtype = check_cuda(name, y)
    if y.dim() != 5 or min(y.shape[1:4]) < 2:
        raise ValueError(f"{name}: y {tuple(y.shape)}, expected "
                         "(B, X, Y, Z, C) with X, Y, Z >= 2")
    b, X, Y, Z, C = y.shape
    n = Z * C if lanes else C
    for v in (scale, shift):
        if (v.device != y.device or v.dtype != torch.float32
                or not v.is_contiguous() or tuple(v.shape) != (n,)):
            raise ValueError(f"{name}: affine vectors must be contiguous "
                             f"float32 ({n},) on {y.device}")
    out = torch.empty(b, X // 2, Y // 2, Z // 2, C, dtype=y.dtype,
                      device=y.device)
    AFFINE_ACT_POOL.launch(
        y.device, y.data_ptr(), scale.data_ptr(), shift.data_ptr(),
        out.data_ptr(), b, X, Y, Z, C, C if lanes else 0, float(slope),
        _MODES[mode], dtype)
    return out


def max_pool3d_2x2_affine_act(y, s_lanes, b_lanes, slope: float = 0.01):
    """maxpool2(leaky(y * s + b)) with (Z*C,) lane vectors (the stem-fed
    stage end). Kernel K4 on CUDA tensors; the plain version on CPU."""
    return _affine_act_pool("max_pool3d_2x2_affine_act", y, s_lanes, b_lanes,
                            slope, "max", lanes=True)


def max_pool3d_2x2_affine_act_bc(y, scale, shift, slope: float = 0.01):
    """maxpool2(leaky(y * s + b)) with per-channel (C,) vectors (the
    conv-fed stage ends)."""
    return _affine_act_pool("max_pool3d_2x2_affine_act_bc", y, scale, shift,
                            slope, "max", lanes=False)


def avg_pool3d_2x2_affine_act(y, scale, shift, slope: float = 0.01):
    """avgpool2(leaky(y * s + b)) with per-channel (C,) vectors: the
    stage-4 end, which the JAX package runs as bn_affine_reference followed
    by avg_pool3d_2x2."""
    return _affine_act_pool("avg_pool3d_2x2_affine_act", y, scale, shift,
                            slope, "avg", lanes=False)


def _identity(x):
    c = x.shape[-1]
    return (torch.ones(c, dtype=torch.float32, device=x.device),
            torch.zeros(c, dtype=torch.float32, device=x.device))


def max_pool3d_2x2(x):
    """(B, X, Y, Z, C) -> floor-halved, torch MaxPool3d(2, 2) forward."""
    return _affine_act_pool("max_pool3d_2x2", x, *_identity(x), 1.0, "max",
                            lanes=False)


def avg_pool3d_2x2(x):
    """(B, X, Y, Z, C) -> floor-halved, torch AvgPool3d(2, 2) forward."""
    return _affine_act_pool("avg_pool3d_2x2", x, *_identity(x), 1.0, "avg",
                            lanes=False)
