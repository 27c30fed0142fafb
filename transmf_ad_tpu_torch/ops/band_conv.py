"""3x3x3 SAME stride-1 convolution with Cin > 1, the full-resolution body conv.

Port of `band_conv3d` and `band_conv3d_stats` from
transmf_ad_tpu/ops/band_conv.py. All tensors are channels-last,
x (B, X, Y, Z, Cin), w (3, 3, 3, Cin, Cout), y (B, X, Y, Z, Cout); the
convolution is linear (no bias: the caller folds it into the BatchNorm
shift).

- `band_conv3d`: kernel K8 (csrc/band_conv.cu). Backward: the input gradient
  is K8 on the output gradient with the weights reversed in space and Cin and
  Cout swapped; the weight gradient is kernel K9 (`band_dw`).
- K8 has two variants, and `variant(dtype, cin, cout)` names the one a CUDA
  launch takes: "mma", an implicit GEMM on the tensor cores, for bfloat16 with
  Cin % 16 == 0, Cin <= 128 and Cout % 8 == 0 (every body conv of the
  full-width models); "direct", float32 FMAs on the CUDA cores, for float32
  and for other channel counts. The choice depends on dtype and shape alone;
  a launch of either that fails raises. `BAND_CONV.by_variant` counts them.
- K9 has two variants as well, named by `dw_variant(dtype, cin, cout)`:
  "mma", an implicit GEMM on the tensor cores over the voxels, for bfloat16
  with Cin % 16 == 0 and Cout % 8 == 0 (both weight gradients of the
  full-width models), and "direct" otherwise; `BAND_DW.by_variant` counts
  them.
- `band_conv3d_stats` (training): K8 with the BatchNorm sums of its float32
  accumulator, float32 (2, Cout) [sum, sum of squares] over B, X, Y, Z, where
  the JAX op returns per-lane (2, Z * Cout) sums that its caller folds at once
  (`st.reshape(2, Z, C).sum(1)`). Its backward folds the sums' cotangents into
  the output gradient: K9 assembles yhat = gy + round(a + y * b2) in registers
  from float32 a, b2; the input gradient's yhat is assembled in the storage
  type with every operation rounded, as the JAX package does, and goes through
  K8.

On CPU tensors every entry runs the plain version beside it (`F.conv3d`, for
the input gradient too, and `conv3d_weight`, in float32, rounded once). K8
is the ops `transmf::band_conv` and `band_conv_stats`, K9 `transmf::band_dw`.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F
from torch.nn.grad import conv3d_weight

from .._build import (INT, PTR, Kernel, check_cuda, define_op, library,
                      save_inputs)

BAND_CONV = Kernel(
    name="band_conv", entry="transmf_band_conv",
    argtypes=(PTR, PTR, PTR, PTR, PTR, INT, INT, INT, INT, INT, INT, INT, INT,
              INT),
    source="transmf_ad_tpu_torch/csrc/band_conv.cu",
    replaces="transmf_ad_tpu/ops/band_conv.py:227")
VARIANTS = ("direct", "mma")  # K8's, by their code in the C interface
MMA_MAX_CIN = 128  # the ring of input halos must fit in shared memory

# also replaces _band_dw_ab_kernel (:369)
BAND_DW = Kernel(
    name="band_dw", entry="transmf_band_dw",
    argtypes=(PTR, PTR, PTR, PTR, PTR, PTR, PTR, INT, INT, INT, INT, INT, INT,
              INT, INT, INT),
    source="transmf_ad_tpu_torch/csrc/band_conv.cu",
    replaces="transmf_ad_tpu/ops/band_conv.py:378")
DW_VARIANTS = ("direct", "mma")  # K9's, by their code in the C interface


def _oidhw(w: torch.Tensor) -> torch.Tensor:
    """(3, 3, 3, Cin, Cout) -> (Cout, Cin, 3, 3, 3), torch's layout."""
    return w.permute(4, 3, 0, 1, 2)


def _ncdhw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 4, 1, 2, 3)


def _conv_f32(x, w):
    """The convolution in float32, channels-last in and out."""
    y = F.conv3d(_ncdhw(x.float()), _oidhw(w.float()), padding=1)
    return y.permute(0, 2, 3, 4, 1).contiguous()


def band_conv_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of K8: float32 sums, rounded once to x's dtype."""
    return _conv_f32(x, w).to(x.dtype)


def band_conv_stats_reference(x: torch.Tensor, w: torch.Tensor):
    """Plain version of K8 with statistics: (y, float32 (2, Cout) [sum, sum
    of squares] of the float32 result before rounding)."""
    acc = _conv_f32(x, w)
    st = torch.stack([acc.sum(dim=(0, 1, 2, 3)),
                      (acc * acc).sum(dim=(0, 1, 2, 3))])
    return acc.to(x.dtype), st


def _yhat(y, gy, a, b2):
    """gy + round(a + y * b2) in y's dtype, a and b2 float32 (K9's yhat)."""
    return gy.to(y.dtype) + (a + y.float() * b2).to(y.dtype)


def band_dw_reference(x, gy, y=None, a=None, b2=None) -> torch.Tensor:
    """Plain version of K9: float32 (3, 3, 3, Cin, Cout) from x and the
    output gradient (yhat when y, a, b2 are given), with float32 sums."""
    yh = gy.to(x.dtype) if a is None else _yhat(y, gy, a, b2)
    cin, cout = x.shape[-1], yh.shape[-1]
    dw = conv3d_weight(_ncdhw(x.float()), (cout, cin, 3, 3, 3),
                       _ncdhw(yh.float()), padding=1)
    return dw.permute(2, 3, 4, 1, 0).contiguous()


def flip_weight(w: torch.Tensor) -> torch.Tensor:
    """The transpose convolution's weights: reversed in space, Cin / Cout
    swapped."""
    return w.flip(0, 1, 2).transpose(3, 4).contiguous()


def variant(dtype: torch.dtype, cin: int, cout: int) -> str:
    """The K8 variant a CUDA launch takes: "mma" (tensor cores) or "direct"
    (CUDA cores), from the dtype and the channel counts alone."""
    if (dtype == torch.bfloat16 and cin % 16 == 0 and cin <= MMA_MAX_CIN
            and cout % 8 == 0):
        return "mma"
    return "direct"


def dw_variant(dtype: torch.dtype, cin: int, cout: int) -> str:
    """The K9 variant a CUDA launch takes: "mma" (tensor cores) or "direct"
    (CUDA cores), from the dtype and the channel counts alone."""
    if dtype == torch.bfloat16 and cin % 16 == 0 and cout % 8 == 0:
        return "mma"
    return "direct"


def _int64_fn(entry):
    fn = getattr(library(), entry)
    fn.argtypes = [INT] * 7
    fn.restype = ctypes.c_int64
    return fn


@functools.cache
def _blocks_fn():
    """K8's spatial blocks for (B, X, Y, Z, Cin, Cout, variant code): the
    rows of its statistics partials."""
    return _int64_fn("transmf_band_blocks")


@functools.cache
def _dw_rows_fn():
    """The rows of K9's partials for (B, X, Y, Z, Cin, Cout, variant
    code)."""
    return _int64_fn("transmf_band_dw_rows")


def _check(name, x, w):
    if x.dim() != 5:
        raise ValueError(f"{name}: x {tuple(x.shape)}, expected "
                         "(B, X, Y, Z, Cin)")
    if w.dim() != 5 or tuple(w.shape[:4]) != (3, 3, 3, x.shape[-1]):
        raise ValueError(f"{name}: w {tuple(w.shape)}, expected "
                         f"(3, 3, 3, {x.shape[-1]}, Cout)")


def _band_launch(x, w, stats: bool):
    """K8 on CUDA tensors, in the variant `variant` names: y or, with
    `stats`, (y, (2, Cout) float32)."""
    name = "band_conv3d_stats" if stats else "band_conv3d"
    dtype = check_cuda(name, x, w)
    _check(name, x, w)
    b, X, Y, Z, cin = x.shape
    cout = w.shape[4]
    which = variant(x.dtype, cin, cout)
    code = VARIANTS.index(which)
    out = torch.empty(b, X, Y, Z, cout, dtype=x.dtype, device=x.device)
    partial = st = None
    if stats:
        partial = torch.empty(2, _blocks_fn()(b, X, Y, Z, cin, cout, code),
                              cout, dtype=torch.float32, device=x.device)
        st = torch.empty(2, cout, dtype=torch.float32, device=x.device)
    BAND_CONV.launch(x.device, x.data_ptr(), w.data_ptr(), out.data_ptr(),
                     partial.data_ptr() if stats else None,
                     st.data_ptr() if stats else None,
                     b, X, Y, Z, cin, cout, int(stats), dtype, code,
                     variant=which)
    return (out, st) if stats else out


def _band_dw_launch(x, gy, y=None, a=None, b2=None) -> torch.Tensor:
    """K9 on CUDA tensors, in the variant `dw_variant` names."""
    name = "band_dw"
    gy = gy.to(x.dtype).contiguous()
    with_ab = a is not None
    dtype = check_cuda(name, x, gy, *((y,) if with_ab else ()))
    if x.dim() != 5 or gy.dim() != 5 or gy.shape[:4] != x.shape[:4]:
        raise ValueError(f"{name}: x {tuple(x.shape)}, gy {tuple(gy.shape)}")
    b, X, Y, Z, cin = x.shape
    cout = gy.shape[-1]
    if with_ab:
        if y.shape != gy.shape:
            raise ValueError(f"{name}: y {tuple(y.shape)}, gy "
                             f"{tuple(gy.shape)}")
        for v in (a, b2):
            if (v.device != x.device or v.dtype != torch.float32
                    or not v.is_contiguous() or tuple(v.shape) != (cout,)):
                raise ValueError(f"{name}: a, b2 must be contiguous float32 "
                                 f"({cout},) on {x.device}")
    which = dw_variant(x.dtype, cin, cout)
    code = DW_VARIANTS.index(which)
    partial = torch.empty(_dw_rows_fn()(b, X, Y, Z, cin, cout, code),
                          27 * cin * cout, dtype=torch.float32,
                          device=x.device)
    dw = torch.empty(3, 3, 3, cin, cout, dtype=torch.float32, device=x.device)
    BAND_DW.launch(x.device, x.data_ptr(),
                   y.data_ptr() if with_ab else None, gy.data_ptr(),
                   a.data_ptr() if with_ab else None,
                   b2.data_ptr() if with_ab else None, partial.data_ptr(),
                   dw.data_ptr(), b, X, Y, Z, cin, cout, int(with_ab), dtype,
                   code, variant=which)
    return dw


def _y_fake(x, w):
    return x.new_empty(*x.shape[:4], w.shape[4])


def _band_backward(ctx, gy):
    """K8 on flipped weights (dx) and K9 (dw), the JAX package's
    `_bc_bwd`."""
    x, w = ctx.saved_tensors
    gyd = gy.to(x.dtype).contiguous()
    dx = dw = None
    if ctx.needs_input_grad[0]:
        dx = _band_forward(gyd, flip_weight(w), False)
    if ctx.needs_input_grad[1]:
        dw = band_dw(x, gyd).to(w.dtype)
    return dx, dw


def _band_stats_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs, output[0])


def _band_stats_backward(ctx, gy, gst):
    """K8 on flipped weights (dx) and K9 with the sums' cotangents (dw),
    the JAX package's `_bcs_bwd`."""
    x, w, y = ctx.saved_tensors
    a = gst[0].float().contiguous()
    b2 = (2.0 * gst[1]).float().contiguous()
    gyd = gy.to(x.dtype).contiguous()
    dx = dw = None
    if ctx.needs_input_grad[0]:
        # every operation rounded to the storage type, a and b2 first
        yhat = gyd + a.to(y.dtype) + y * b2.to(y.dtype)
        dx = _band_forward(yhat, flip_weight(w), False)
    if ctx.needs_input_grad[1]:
        dw = band_dw(x, gyd, y, a, b2).to(w.dtype)
    return dx, dw


band_conv_op = define_op(
    "band_conv(Tensor x, Tensor w) -> Tensor", band_conv_reference,
    functools.partial(_band_launch, stats=False), _y_fake, _band_backward,
    save_inputs)
band_conv_stats_op = define_op(
    "band_conv_stats(Tensor x, Tensor w) -> (Tensor, Tensor)",
    band_conv_stats_reference, functools.partial(_band_launch, stats=True),
    lambda x, w: (_y_fake(x, w),
                  x.new_empty(2, w.shape[4], dtype=torch.float32)),
    _band_stats_backward, _band_stats_setup)
band_dw_op = define_op(
    "band_dw(Tensor x, Tensor gy, Tensor? y=None, Tensor? a=None, "
    "Tensor? b2=None) -> Tensor", band_dw_reference, _band_dw_launch,
    lambda x, gy, *_: x.new_empty(3, 3, 3, x.shape[4], gy.shape[4],
                                  dtype=torch.float32))


def _band_forward(x, w, stats: bool):
    """The band conv's op: y or, with `stats`, (y, (2, Cout) float32)."""
    return band_conv_stats_op(x, w) if stats else band_conv_op(x, w)


def band_dw(x, gy, y=None, a=None, b2=None) -> torch.Tensor:
    """Weight gradient of the band conv: float32 (3, 3, 3, Cin, Cout) from
    the input x and the output gradient gy; with the conv output y and the
    float32 (Cout,) cotangents a (of the sums) and b2 (twice that of the
    sums of squares), from yhat = gy + round(a + y * b2). Kernel K9 on CUDA
    tensors (the variant `dw_variant` names); the plain version on CPU."""
    if (y is None) != (a is None) or (a is None) != (b2 is None):
        raise ValueError("band_dw: y, a and b2 go together")
    return band_dw_op(x, gy, y, a, b2)


def band_conv3d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3x3 SAME stride-1 conv, (B, X, Y, Z, Cin) x (3, 3, 3, Cin, Cout) ->
    (B, X, Y, Z, Cout), linear. Kernel K8 on CUDA tensors, backward K8 and
    K9; the plain versions on CPU tensors."""
    return _band_forward(x, w, False)


def band_conv3d_stats(x: torch.Tensor, w: torch.Tensor):
    """`band_conv3d` plus float32 (2, Cout) [sum, sum of squares] of the
    float32 accumulator over B, X, Y, Z."""
    return _band_forward(x, w, True)
