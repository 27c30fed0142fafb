"""Single-channel 3x3x3 SAME convolution, the sNet stem.

Port of `stem_conv` and `stem_conv_stats` from transmf_ad_tpu/ops/stem.py:

- `stem_conv` (eval): kernel K3 (csrc/stem_conv.cu). Its backward is plain
  PyTorch, as the JAX package's is `jax.linear_transpose` of an XLA conv.
- `stem_conv_stats` (training): kernel K5, the same convolution plus the
  BatchNorm sums of its float32 accumulator. Its backward is the weight
  gradient kernel K6 (`stem_dw`), which folds the statistics' cotangents into
  the output gradient on the fly; the input gradient is dead in training and
  is computed in plain PyTorch only when asked for.

The z-blocked full-resolution forms are still to port (ROADMAP.md Queue 2
item 6).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F
from torch.nn.grad import conv3d_input, conv3d_weight

from .._build import INT, PTR, Kernel, check_cuda, library

STEM_CONV = Kernel(
    name="stem_conv", entry="transmf_stem_conv",
    argtypes=(PTR, PTR, PTR, INT, INT, INT, INT, INT, INT),
    source="transmf_ad_tpu_torch/csrc/stem_conv.cu",
    replaces="transmf_ad_tpu/ops/stem.py:99")

STEM_CONV_STATS = Kernel(
    name="stem_conv_stats", entry="transmf_stem_conv_stats",
    argtypes=(PTR, PTR, PTR, PTR, PTR, INT, INT, INT, INT, INT, INT),
    source="transmf_ad_tpu_torch/csrc/stem_conv.cu",
    replaces="transmf_ad_tpu/ops/stem.py:195")

STEM_DW = Kernel(
    name="stem_dw", entry="transmf_stem_dw",
    argtypes=(PTR, PTR, PTR, PTR, PTR, PTR, PTR, INT, INT, INT, INT, INT,
              INT),
    source="transmf_ad_tpu_torch/csrc/stem_conv.cu",
    replaces="transmf_ad_tpu/ops/stem.py:332")

MAX_CHANNELS = 256


def _oidhw(w: torch.Tensor) -> torch.Tensor:
    """(3, 3, 3, C) -> (C, 1, 3, 3, 3), torch's conv weight layout."""
    return w.permute(3, 0, 1, 2).unsqueeze(1)


def _conv_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (B, X, Y, Z), w: (3, 3, 3, C) -> (B, X, Y, Z, C), no bias."""
    y = F.conv3d(x.unsqueeze(1), _oidhw(w), padding=1)  # (B, C, X, Y, Z)
    return y.permute(0, 2, 3, 4, 1).contiguous()


def _stem_stats_reference(x: torch.Tensor, w: torch.Tensor):
    """(y, (2, C) float32 [sum, sum of squares]): the convolution in
    float32, the sums of that float32 result over B, X, Y, Z, and y
    rounded once to x's dtype, as K5 does."""
    acc = _conv_reference(x.float(), w.float())
    st = torch.stack([acc.sum(dim=(0, 1, 2, 3)),
                      (acc * acc).sum(dim=(0, 1, 2, 3))])
    return acc.to(x.dtype), st


def _yhat(y, gy, a, b2):
    """gy + round(a + y * b2) in y's dtype: the output gradient with the
    cotangents of the sums folded in (a = d/d sum, b2 = 2 d/d sumsq)."""
    stat = (a + y.float() * b2).to(y.dtype)
    return gy.to(y.dtype) + stat


def stem_dw_reference(x, y, gy, a, b2) -> torch.Tensor:
    """float32 (3, 3, 3, C) weight gradient from yhat (see `_yhat`), with
    float32 sums."""
    yh = _yhat(y, gy, a, b2).float().permute(0, 4, 1, 2, 3)
    c = y.shape[-1]
    dw = conv3d_weight(x.float().unsqueeze(1), (c, 1, 3, 3, 3), yh,
                       padding=1)
    return dw[:, 0].permute(1, 2, 3, 0).contiguous()


def _check_stem(name, x, c: int):
    if x.dim() != 4:
        raise ValueError(f"{name}: x {tuple(x.shape)}, expected (B, X, Y, Z)")
    b, X = x.shape[:2]
    if c > MAX_CHANNELS or b * X > 65535:
        raise ValueError(f"{name}: C={c} (max {MAX_CHANNELS}) or "
                         f"B*X={b * X} (max 65535) out of range")


def _check_weight(name, w):
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, 3):
        raise ValueError(f"{name}: w {tuple(w.shape)}, expected (3, 3, 3, C)")


@functools.cache
def _blocks_fn():
    fn = library().transmf_stem_blocks
    fn.argtypes = [INT, INT, INT, INT]
    fn.restype = ctypes.c_int64
    return fn


def _stem_forward(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return _conv_reference(x, w)
    dtype = check_cuda("stem_conv", x, w)
    _check_weight("stem_conv", w)
    _check_stem("stem_conv", x, w.shape[3])
    b, X, Y, Z = x.shape
    c = w.shape[3]
    out = torch.empty(b, X, Y, Z, c, dtype=x.dtype, device=x.device)
    STEM_CONV.launch(x.device, x.data_ptr(), w.data_ptr(), out.data_ptr(),
                     b, X, Y, Z, c, dtype)
    return out


def _stem_stats_forward(x: torch.Tensor, w: torch.Tensor):
    if x.device.type == "cpu":
        return _stem_stats_reference(x, w)
    name = "stem_conv_stats"
    dtype = check_cuda(name, x, w)
    _check_weight(name, w)
    _check_stem(name, x, w.shape[3])
    b, X, Y, Z = x.shape
    c = w.shape[3]
    out = torch.empty(b, X, Y, Z, c, dtype=x.dtype, device=x.device)
    partial = torch.empty(2, _blocks_fn()(b, X, Y, Z), c,
                          dtype=torch.float32, device=x.device)
    st = torch.empty(2, c, dtype=torch.float32, device=x.device)
    STEM_CONV_STATS.launch(x.device, x.data_ptr(), w.data_ptr(),
                           out.data_ptr(), partial.data_ptr(), st.data_ptr(),
                           b, X, Y, Z, c, dtype)
    return out, st


def stem_dw(x, y, gy, a, b2) -> torch.Tensor:
    """Stem weight gradient: float32 (3, 3, 3, C) from the input x
    (B, X, Y, Z), the output y and its gradient gy (B, X, Y, Z, C), and the
    float32 (C,) cotangents a (of the sums) and b2 (twice that of the sums
    of squares). Kernel K6 on CUDA tensors; the plain version on CPU."""
    if x.device.type == "cpu":
        return stem_dw_reference(x, y, gy, a, b2)
    name = "stem_dw"
    gy = gy.to(y.dtype).contiguous()
    dtype = check_cuda(name, x, y, gy)
    _check_stem(name, x, y.shape[-1])
    b, X, Y, Z = x.shape
    c = y.shape[-1]
    if tuple(y.shape) != (b, X, Y, Z, c) or gy.shape != y.shape:
        raise ValueError(f"{name}: y {tuple(y.shape)}, gy {tuple(gy.shape)} "
                         f"for x {tuple(x.shape)}")
    for v in (a, b2):
        if (v.device != x.device or v.dtype != torch.float32
                or not v.is_contiguous() or tuple(v.shape) != (c,)):
            raise ValueError(f"{name}: a, b2 must be contiguous float32 "
                             f"({c},) on {x.device}")
    partial = torch.empty(_blocks_fn()(b, X, Y, Z), 27 * c,
                          dtype=torch.float32, device=x.device)
    dw = torch.empty(3, 3, 3, c, dtype=torch.float32, device=x.device)
    STEM_DW.launch(x.device, x.data_ptr(), y.data_ptr(), gy.data_ptr(),
                   a.data_ptr(), b2.data_ptr(), partial.data_ptr(),
                   dw.data_ptr(), b, X, Y, Z, c, dtype)
    return dw


def _dx(x, w, g):
    """Input gradient of the stem conv (the transpose conv), plain."""
    gt = g.to(x.dtype).permute(0, 4, 1, 2, 3)
    return conv3d_input(x.unsqueeze(1).shape, _oidhw(w).to(x.dtype), gt,
                        padding=1)[:, 0]


class _StemConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _stem_forward(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = _dx(x, w, g) if ctx.needs_input_grad[0] else None
        dw = None
        if ctx.needs_input_grad[1]:
            gt = g.to(w.dtype).permute(0, 4, 1, 2, 3)
            dw = conv3d_weight(x.to(w.dtype).unsqueeze(1), (w.shape[3], 1, 3,
                                                            3, 3), gt,
                               padding=1)[:, 0].permute(1, 2, 3, 0)
        return dx, dw


class _StemConvStats(torch.autograd.Function):
    """K5 forward, K6 backward (the JAX package's `_ss_fwd` / `_ss_bwd`)."""

    @staticmethod
    def forward(ctx, x, w):
        y, st = _stem_stats_forward(x, w)
        ctx.save_for_backward(x, w, y)
        return y, st

    @staticmethod
    def backward(ctx, gy, gst):
        x, w, y = ctx.saved_tensors
        a = gst[0].float().contiguous()
        b2 = (2.0 * gst[1]).float().contiguous()
        dw = stem_dw(x, y, gy.contiguous(), a, b2).to(w.dtype)
        dx = None
        if ctx.needs_input_grad[0]:  # dead in training: the input volume
            yhat = gy.to(y.dtype) + a.to(y.dtype) + y * b2.to(y.dtype)
            dx = _dx(x, w, yhat)
        return dx, dw


def stem_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Single-channel 3x3x3 SAME conv: (B, X, Y, Z) x (3, 3, 3, C) ->
    (B, X, Y, Z, C), linear (the caller folds bias, BN and activation into
    the stage-end pool). Kernel K3 on CUDA tensors; the plain version on CPU
    tensors. Differentiable, with a plain backward."""
    return _StemConv.apply(x, w)


def stem_conv_stats(x: torch.Tensor, w: torch.Tensor):
    """`stem_conv` plus float32 (2, C) [sum, sum of squares] of the float32
    accumulator over B, X, Y, Z. Per channel, where the JAX op returns
    per-lane (2, Z*C) sums that its caller folds at once
    (`st.reshape(2, Z, C).sum(1)`). Kernel K5 on CUDA tensors, backward K6;
    the plain versions on CPU tensors."""
    return _StemConvStats.apply(x, w)
