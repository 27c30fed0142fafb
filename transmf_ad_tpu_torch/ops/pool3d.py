"""2x2x2 stride-2 pooling with a fused affine + LeakyReLU prologue.

Port of transmf_ad_tpu/ops/pool3d.py. The JAX package keeps two layouts of
one piece of math for the TPU (the merged (B, X, Y, Z*C) view with (Z*C,)
lane vectors, and the conv-native view with (C,) vectors); on the card both
are one channels-last kernel, K4 (csrc/pool3d.cu), which reads the affine
through a z-stride. Plain pooling is the same kernel with an identity affine.

Every entry is differentiable. Its backward is kernel K7 (csrc/pool3d.cu):
it recomputes the forward's rounded activation, routes the pooled gradient
through the window-equality mask (ties split equally, as the TPU kernels do;
torch's index-based max-pool backward would not), and returns dy together
with the float32 sums d(scale) = sum(dpre * y) and d(shift) = sum(dpre), per
lane or per channel. `affine_act_pool_bwd_reference` is its plain version.

All entries take and return channels-last (B, X, Y, Z, C) tensors; odd
tails are dropped (floor semantics, torch MaxPool3d(2, 2)) and get zero
gradient.
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

# also replaces _bc_bwd_kernel (:820), _avg_bwd_kernel (:300) and
# _pool_bwd_kernel (:163)
AFFINE_ACT_POOL_BWD = Kernel(
    name="affine_act_pool_bwd", entry="transmf_affine_act_pool_bwd",
    argtypes=(PTR, PTR, PTR, PTR, PTR, PTR, PTR, PTR, INT, INT, INT, INT, INT,
              INT, FLOAT, INT, INT, INT, INT),
    source="transmf_ad_tpu_torch/csrc/pool3d.cu",
    replaces="transmf_ad_tpu/ops/pool3d.py:543")

_MODES = {"max": 0, "avg": 1}
_BWD_BLOCKS = 2 * 132  # K7 blocks: two 512-thread blocks per H100 SM


def _affine(scale, C):
    """(C,) -> (1, C) and (Z*C,) -> (Z, C); both broadcast over (..., Z, C)."""
    return scale.reshape(-1, C)


def affine_act_pool_reference(y, scale, shift, slope: float, mode: str):
    """pool(round(leaky(y * s + b))) in plain PyTorch. scale/shift are f32
    (C,) vectors or (Z*C,) lane vectors; the activation is rounded to y's
    dtype before the max or the float32 mean."""
    b, X, Y, Z, C = y.shape
    z = y.float() * _affine(scale, C) + _affine(shift, C)
    z = torch.where(z >= 0, z, slope * z).to(y.dtype)
    Xp, Yp, Zp = X // 2, Y // 2, Z // 2
    win = z[:, :2 * Xp, :2 * Yp, :2 * Zp].reshape(b, Xp, 2, Yp, 2, Zp, 2, C)
    if mode == "max":
        return win.amax(dim=(2, 4, 6))
    return (win.float().sum(dim=(2, 4, 6)) * 0.125).to(y.dtype)


def affine_act_pool_bwd_reference(y, scale, shift, p, g, slope: float,
                                  mode: str, round_gi: bool):
    """Backward of `affine_act_pool_reference`, written out as the TPU
    kernels compute it (not autograd of the forward): returns dy (y's
    shape and dtype, zero on odd tails) and float32 (2, n) [d(scale),
    d(shift)], n = scale.numel().

    max: gi = g / max(#ties, 1), rounded to y's dtype when `round_gi`
    (_mpa_bwd_kernel, _pool_bwd_kernel) or kept in float32
    (_bc_bwd_kernel), routed to every window element equal to p. avg:
    gi = round(g / 8) to every window element (_avg_bwd_kernel). Then
    dpre = gi * leaky'(pre) and dy = round(dpre * s)."""
    b, X, Y, Z, C = y.shape
    Xp, Yp, Zp = X // 2, Y // 2, Z // 2
    s, sh = _affine(scale, C), _affine(shift, C)
    lanes = s.shape[0] > 1
    if lanes:
        s, sh = s[:2 * Zp], sh[:2 * Zp]
    yf = y[:, :2 * Xp, :2 * Yp, :2 * Zp].float()
    pre = yf * s + sh
    gf = g.to(y.dtype).float()[:, :, None, :, None, :, None]
    if mode == "max":
        z = torch.where(pre >= 0, pre, slope * pre).to(y.dtype).float()
        z = z.reshape(b, Xp, 2, Yp, 2, Zp, 2, C)
        eq = z == p.to(y.dtype).float()[:, :, None, :, None, :, None]
        cnt = eq.sum(dim=(2, 4, 6), keepdim=True).float()
        gi = gf / cnt.clamp(min=1.0)
        if round_gi:
            gi = gi.to(y.dtype).float()
        dz = torch.where(eq, gi, torch.zeros((), dtype=torch.float32))
    else:
        gi = (gf * 0.125).to(y.dtype).float()
        dz = gi.expand(b, Xp, 2, Yp, 2, Zp, 2, C)
    dz = dz.reshape(yf.shape)
    dpre = torch.where(pre >= 0, dz, dz * slope)
    dy = torch.zeros_like(y)
    dy[:, :2 * Xp, :2 * Yp, :2 * Zp] = (dpre * s).to(y.dtype)
    dsb = torch.stack([(dpre * yf).sum(dim=(0, 1, 2)), dpre.sum(dim=(0, 1, 2))])
    if lanes:  # (2, 2Zp, C) -> (2, Z*C), zero on the odd z tail
        full = torch.zeros(2, Z, C, dtype=torch.float32, device=y.device)
        full[:, :2 * Zp] = dsb
        return dy, full.reshape(2, Z * C)
    return dy, dsb.sum(dim=1)


def _check_affine(name, y, n, *vectors):
    for v in vectors:
        if (v.device != y.device or v.dtype != torch.float32
                or not v.is_contiguous() or tuple(v.shape) != (n,)):
            raise ValueError(f"{name}: affine vectors must be contiguous "
                             f"float32 ({n},) on {y.device}")


def _check_volume(name, y):
    if y.dim() != 5 or min(y.shape[1:4]) < 2:
        raise ValueError(f"{name}: y {tuple(y.shape)}, expected "
                         "(B, X, Y, Z, C) with X, Y, Z >= 2")


def _affine_act_pool(name, y, scale, shift, slope, mode, lanes):
    if y.device.type == "cpu":
        return affine_act_pool_reference(y, scale, shift, slope, mode)
    dtype = check_cuda(name, y)
    _check_volume(name, y)
    b, X, Y, Z, C = y.shape
    _check_affine(name, y, Z * C if lanes else C, scale, shift)
    out = torch.empty(b, X // 2, Y // 2, Z // 2, C, dtype=y.dtype,
                      device=y.device)
    AFFINE_ACT_POOL.launch(
        y.device, y.data_ptr(), scale.data_ptr(), shift.data_ptr(),
        out.data_ptr(), b, X, Y, Z, C, C if lanes else 0, float(slope),
        _MODES[mode], dtype)
    return out


def affine_act_pool_bwd(y, scale, shift, p, g, slope: float, mode: str,
                        lanes: bool, round_gi: bool):
    """(dy, (2, n) float32 [d(scale), d(shift)]) for the forward output p
    and its gradient g. Kernel K7 on CUDA tensors; the plain version on
    CPU tensors."""
    name = "affine_act_pool_bwd"
    if y.device.type == "cpu":
        return affine_act_pool_bwd_reference(y, scale, shift, p, g, slope,
                                             mode, round_gi)
    g = g.to(y.dtype).contiguous()
    dtype = check_cuda(name, y, p, g)
    _check_volume(name, y)
    b, X, Y, Z, C = y.shape
    n = Z * C if lanes else C
    _check_affine(name, y, n, scale, shift)
    pooled = (b, X // 2, Y // 2, Z // 2, C)
    if tuple(p.shape) != pooled or tuple(g.shape) != pooled:
        raise ValueError(f"{name}: p {tuple(p.shape)}, g {tuple(g.shape)}; "
                         f"expected {pooled}")
    grid = min(b * ((X + 1) // 2) * ((Y + 1) // 2), _BWD_BLOCKS)
    dy = torch.empty_like(y)
    partial = torch.empty(2, grid, Z * C, dtype=torch.float32,
                          device=y.device)
    dsb = torch.empty(2, n, dtype=torch.float32, device=y.device)
    AFFINE_ACT_POOL_BWD.launch(
        y.device, y.data_ptr(), scale.data_ptr(), shift.data_ptr(),
        p.data_ptr(), g.data_ptr(), dy.data_ptr(), partial.data_ptr(),
        dsb.data_ptr(), b, X, Y, Z, C, C if lanes else 0, float(slope),
        _MODES[mode], int(round_gi), grid, dtype)
    return dy, dsb


class _AffineActPool(torch.autograd.Function):
    """K4 forward, K7 backward; saves (y, scale, shift, p) as the JAX
    custom_vjp does."""

    @staticmethod
    def forward(ctx, y, scale, shift, name, slope, mode, lanes, round_gi):
        p = _affine_act_pool(name, y, scale, shift, slope, mode, lanes)
        ctx.save_for_backward(y, scale, shift, p)
        ctx.args = (slope, mode, lanes, round_gi)
        return p

    @staticmethod
    def backward(ctx, g):
        y, scale, shift, p = ctx.saved_tensors
        dy, dsb = affine_act_pool_bwd(y, scale, shift, p, g.contiguous(),
                                      *ctx.args)
        return dy, dsb[0], dsb[1], None, None, None, None, None


def max_pool3d_2x2_affine_act(y, s_lanes, b_lanes, slope: float = 0.01):
    """maxpool2(leaky(y * s + b)) with (Z*C,) lane vectors (the stem-fed
    stage end). Kernel K4 on CUDA tensors, backward K7 with g/count
    rounded to y's dtype (_mpa_bwd_kernel); the plain versions on CPU."""
    return _AffineActPool.apply(y, s_lanes, b_lanes,
                                "max_pool3d_2x2_affine_act", slope, "max",
                                True, True)


def max_pool3d_2x2_affine_act_bc(y, scale, shift, slope: float = 0.01):
    """maxpool2(leaky(y * s + b)) with per-channel (C,) vectors (the
    conv-fed stage ends); backward K7 with g/count in float32
    (_bc_bwd_kernel)."""
    return _AffineActPool.apply(y, scale, shift,
                                "max_pool3d_2x2_affine_act_bc", slope, "max",
                                False, False)


def avg_pool3d_2x2_affine_act(y, scale, shift, slope: float = 0.01):
    """avgpool2(leaky(y * s + b)) with per-channel (C,) vectors: the
    stage-4 end, which the JAX package runs as bn_affine_reference followed
    by avg_pool3d_2x2; backward K7 in mean mode (_avg_bwd_kernel followed
    by the affine's backward)."""
    return _AffineActPool.apply(y, scale, shift, "avg_pool3d_2x2_affine_act",
                                slope, "avg", False, False)


def _identity(x):
    c = x.shape[-1]
    return (torch.ones(c, dtype=torch.float32, device=x.device),
            torch.zeros(c, dtype=torch.float32, device=x.device))


def max_pool3d_2x2(x):
    """(B, X, Y, Z, C) -> floor-halved, torch MaxPool3d(2, 2) forward; the
    backward splits the gradient equally among tied maxima
    (_pool_bwd_kernel)."""
    return _AffineActPool.apply(x, *_identity(x), "max_pool3d_2x2", 1.0,
                                "max", False, True)


def avg_pool3d_2x2(x):
    """(B, X, Y, Z, C) -> floor-halved, torch AvgPool3d(2, 2)."""
    return _AffineActPool.apply(x, *_identity(x), "avg_pool3d_2x2", 1.0,
                                "avg", False, False)
