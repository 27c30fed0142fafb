"""Single-channel 3x3x3 SAME convolution, the sNet stem.

Port of `stem_conv` and `stem_conv_stats` from transmf_ad_tpu/ops/stem.py:

- `stem_conv` (eval): kernel K3 (csrc/stem_conv.cu). Its backward is plain
  PyTorch, as the JAX package's is `jax.linear_transpose` of an XLA conv.
- `stem_conv_stats` (training): kernel K5, the same convolution plus the
  BatchNorm sums of its float32 accumulator. Its backward is the weight
  gradient kernel K6 (`stem_dw`), which folds the statistics' cotangents into
  the output gradient on the fly; the input gradient is dead in training and
  is computed in plain PyTorch only when asked for.

The JAX package's z-blocked full-resolution forms (`stem_conv_stats_blocked`
and its blocked weight gradient) chunk z to fit the TPU's VMEM; K3, K5 and K6
tile every volume alike, so the same three kernels take 182x218x182 inputs.

Each of the three has a tensor-core variant "mma" (bfloat16 at the models'
stem widths) and a CUDA-core variant "direct" (float32 and other channel
counts): `conv_variant` names K3's and K5's, `dw_variant` K6's. Each is the
op `transmf::stem_conv`, `stem_conv_stats` or `stem_dw`.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F
from torch.nn.grad import conv3d_input, conv3d_weight

from .._build import (INT, PTR, Kernel, check_cuda, define_op, library,
                      save_inputs)

STEM_CONV = Kernel(
    name="stem_conv", entry="transmf_stem_conv",
    argtypes=(PTR, PTR, PTR, INT, INT, INT, INT, INT, INT, INT),
    source="transmf_ad_tpu_torch/csrc/stem_conv.cu",
    replaces="transmf_ad_tpu/ops/stem.py:99")

STEM_CONV_STATS = Kernel(
    name="stem_conv_stats", entry="transmf_stem_conv_stats",
    argtypes=(PTR, PTR, PTR, PTR, PTR, INT, INT, INT, INT, INT, INT, INT),
    source="transmf_ad_tpu_torch/csrc/stem_conv.cu",
    replaces="transmf_ad_tpu/ops/stem.py:195")
CONV_VARIANTS = ("direct", "mma")  # K3's and K5's, by their code in C

# also replaces _stem_dw_blocked_kernel (:470)
STEM_DW = Kernel(
    name="stem_dw", entry="transmf_stem_dw",
    argtypes=(PTR, PTR, PTR, PTR, PTR, PTR, PTR, INT, INT, INT, INT, INT,
              INT, INT),
    source="transmf_ad_tpu_torch/csrc/stem_conv.cu",
    replaces="transmf_ad_tpu/ops/stem.py:332")
DW_VARIANTS = ("direct", "mma")  # K6's, by their code in the C interface
# K6: 64 float32 sums a thread, and the ring fits in 227 KB; K3 / K5: the
# weights, one row's accumulators and the sums, C / 2 registers each
MMA_MAX_CHANNELS = 64

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


def _check_stem(name, x, c: int, grid: bool = True):
    """x is (B, X, Y, Z), C at most MAX_CHANNELS and, with `grid` (the
    CUDA-core variants' 3-D grid), B * X at most 65535."""
    if x.dim() != 4:
        raise ValueError(f"{name}: x {tuple(x.shape)}, expected (B, X, Y, Z)")
    b, X = x.shape[:2]
    if c > MAX_CHANNELS or (grid and b * X > 65535):
        raise ValueError(f"{name}: C={c} (max {MAX_CHANNELS}) or "
                         f"B*X={b * X} (max 65535) out of range")


def _check_weight(name, w):
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, 3):
        raise ValueError(f"{name}: w {tuple(w.shape)}, expected (3, 3, 3, C)")


@functools.cache
def _blocks_fn():
    fn = library().transmf_stem_blocks
    fn.argtypes = [INT] * 5
    fn.restype = ctypes.c_int64
    return fn


@functools.cache
def _dw_rows_fn():
    fn = library().transmf_stem_dw_rows
    fn.argtypes = [INT] * 5
    fn.restype = ctypes.c_int64
    return fn


def dw_variant(dtype: torch.dtype, c: int) -> str:
    """The K6 variant a CUDA launch takes, from the dtype and the channel
    count alone: "mma" (tensor cores) for bfloat16 with C a multiple of 16
    (the product's n8 tiles, loaded two at a time) up to 64 (its float32
    sums stay in a thread's registers), else "direct" (CUDA cores)."""
    if dtype == torch.bfloat16 and c % 16 == 0 and c <= MMA_MAX_CHANNELS:
        return "mma"
    return "direct"


def conv_variant(dtype: torch.dtype, c: int) -> str:
    """The K3 and K5 variant a CUDA launch takes, from the dtype and the
    channel count alone: "mma" (tensor cores) for bfloat16 with C a
    multiple of 16 (the output's n8 tiles, stored by quads as 16- or
    8-byte pieces) up to 64 (weights, accumulators and sums in a thread's
    registers), else "direct" (CUDA cores). K6's rule, for the same
    reasons of shape."""
    return dw_variant(dtype, c)


def _stem_launch(name, x, w, stats: bool):
    """K3 (or K5 with `stats`) on CUDA tensors, in the variant that
    `conv_variant` names: y, and with `stats` the (2, C) sums."""
    dtype = check_cuda(name, x, w)
    _check_weight(name, w)
    c = w.shape[3]
    which = conv_variant(x.dtype, c)
    _check_stem(name, x, c, grid=which == "direct")
    b, X, Y, Z = x.shape
    code = CONV_VARIANTS.index(which)
    out = torch.empty(b, X, Y, Z, c, dtype=x.dtype, device=x.device)
    if not stats:
        STEM_CONV.launch(x.device, x.data_ptr(), w.data_ptr(), out.data_ptr(),
                         b, X, Y, Z, c, dtype, code, variant=which)
        return out
    partial = torch.empty(2, _blocks_fn()(b, X, Y, Z, code), c,
                          dtype=torch.float32, device=x.device)
    st = torch.empty(2, c, dtype=torch.float32, device=x.device)
    STEM_CONV_STATS.launch(x.device, x.data_ptr(), w.data_ptr(),
                           out.data_ptr(), partial.data_ptr(), st.data_ptr(),
                           b, X, Y, Z, c, dtype, code, variant=which)
    return out, st


def _stem_dw_launch(x, y, gy, a, b2) -> torch.Tensor:
    """K6 on CUDA tensors, in the variant `dw_variant` names."""
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
    which = dw_variant(y.dtype, c)
    code = DW_VARIANTS.index(which)
    partial = torch.empty(_dw_rows_fn()(b, X, Y, Z, code), 27 * c,
                          dtype=torch.float32, device=x.device)
    dw = torch.empty(3, 3, 3, c, dtype=torch.float32, device=x.device)
    STEM_DW.launch(x.device, x.data_ptr(), y.data_ptr(), gy.data_ptr(),
                   a.data_ptr(), b2.data_ptr(), partial.data_ptr(),
                   dw.data_ptr(), b, X, Y, Z, c, dtype, code, variant=which)
    return dw


stem_dw_op = define_op(
    "stem_dw(Tensor x, Tensor y, Tensor gy, Tensor a, Tensor b2) -> Tensor",
    stem_dw_reference, _stem_dw_launch,
    lambda x, y, gy, a, b2: x.new_empty(3, 3, 3, y.shape[-1],
                                        dtype=torch.float32))


def stem_dw(x, y, gy, a, b2) -> torch.Tensor:
    """Stem weight gradient: float32 (3, 3, 3, C) from the input x
    (B, X, Y, Z), the output y and its gradient gy (B, X, Y, Z, C), and the
    float32 (C,) cotangents a (of the sums) and b2 (twice that of the sums
    of squares). Kernel K6 on CUDA tensors, in the variant `dw_variant`
    names; the plain version on CPU."""
    return stem_dw_op(x, y, gy, a, b2)


def _dx(x, w, g):
    """Input gradient of the stem conv (the transpose conv), plain."""
    gt = g.to(x.dtype).permute(0, 4, 1, 2, 3)
    return conv3d_input(x.unsqueeze(1).shape, _oidhw(w).to(x.dtype), gt,
                        padding=1)[:, 0]


def _y_fake(x, w):
    return x.new_empty(*x.shape, w.shape[3])


def _stem_backward(ctx, g):
    """Plain, as the JAX package's is the transpose of an XLA conv."""
    x, w = ctx.saved_tensors
    dx = _dx(x, w, g) if ctx.needs_input_grad[0] else None
    dw = None
    if ctx.needs_input_grad[1]:
        gt = g.to(w.dtype).permute(0, 4, 1, 2, 3)
        dw = conv3d_weight(x.to(w.dtype).unsqueeze(1), (w.shape[3], 1, 3,
                                                        3, 3), gt,
                           padding=1)[:, 0].permute(1, 2, 3, 0)
    return dx, dw


def _stem_stats_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs, output[0])


def _stem_stats_backward(ctx, gy, gst):
    """K6 (the JAX package's `_ss_bwd`)."""
    x, w, y = ctx.saved_tensors
    a = gst[0].float().contiguous()
    b2 = (2.0 * gst[1]).float().contiguous()
    dw = stem_dw(x, y, gy.contiguous(), a, b2).to(w.dtype)
    dx = None
    if ctx.needs_input_grad[0]:  # dead in training: the input volume
        yhat = gy.to(y.dtype) + a.to(y.dtype) + y * b2.to(y.dtype)
        dx = _dx(x, w, yhat)
    return dx, dw


stem_conv_op = define_op(
    "stem_conv(Tensor x, Tensor w) -> Tensor", _conv_reference,
    functools.partial(_stem_launch, "stem_conv", stats=False), _y_fake,
    _stem_backward, save_inputs)
stem_conv_stats_op = define_op(
    "stem_conv_stats(Tensor x, Tensor w) -> (Tensor, Tensor)",
    _stem_stats_reference,
    functools.partial(_stem_launch, "stem_conv_stats", stats=True),
    lambda x, w: (_y_fake(x, w),
                  x.new_empty(2, w.shape[3], dtype=torch.float32)),
    _stem_stats_backward, _stem_stats_setup)


def stem_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Single-channel 3x3x3 SAME conv: (B, X, Y, Z) x (3, 3, 3, C) ->
    (B, X, Y, Z, C), linear (the caller folds bias, BN and activation into
    the stage-end pool). Kernel K3 on CUDA tensors, in the variant
    `conv_variant` names; the plain version on CPU tensors. Differentiable,
    with a plain backward."""
    return stem_conv_op(x, w)


def stem_conv_stats(x: torch.Tensor, w: torch.Tensor):
    """`stem_conv` plus float32 (2, C) [sum, sum of squares] of the float32
    accumulator over B, X, Y, Z. Per channel, where the JAX op returns
    per-lane (2, Z*C) sums that its caller folds at once
    (`st.reshape(2, Z, C).sum(1)`). Kernel K5 on CUDA tensors (in the
    variant `conv_variant` names), backward K6; the plain versions on CPU
    tensors."""
    return stem_conv_stats_op(x, w)
