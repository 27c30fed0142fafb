"""The kernels of the PyTorch/CUDA port as registered `torch.library` ops.

Every kernel K1-K12 and K14 is reached through one op of the `transmf`
namespace: the dispatcher picks the kernel for CUDA tensors and the plain
version for CPU tensors, and FakeTensors see the op's fake implementation.
`torch.library.opcheck` holds, per op and dtype, the schema (no output
aliases an input), the fake implementation against the plain version
(shape, dtype, strides), the autograd registration and the op under
`aot_autograd` with dynamic shapes. Imports no jax; the `cuda` cases run
the same checks against the kernels on a card:

    python -m pytest tests/test_torch_library_ops.py --noconftest -m cuda -q
"""

import pathlib
import re

import pytest
import torch

from transmf_ad_tpu_torch import _build
from transmf_ad_tpu_torch.ops import (band_conv, flash_attention as fa,
                                      pool3d, pooling, stem)
from transmf_ad_tpu_torch.ops import window_attention as wa

OPS_DIR = pathlib.Path(pool3d.__file__).parent
BF16, F32 = torch.bfloat16, torch.float32


def _t(g, *shape, dtype=F32, grad=False, scale=1.0):
    x = (scale * torch.randn(*shape, generator=g)).to(dtype)
    return x.requires_grad_(grad)


POOLS = [(mode, lanes) for mode in ("max", "avg") for lanes in (False, True)]


def _cases(g, dtype, device="cpu", pools=POOLS):
    """(op, args) at tiny, odd shapes: the differentiable ops with inputs
    that require grad (their backward is checked too), the backward ops
    with plain tensors; K4 and K7 in each (mode, lanes) of `pools`."""
    def t(*shape, f32=False, grad=False, scale=1.0):
        return _t(g, *shape, dtype=F32 if f32 else dtype, grad=grad,
                  scale=scale).to(device).detach().requires_grad_(grad)

    q, k, v = t(2, 2, 5, 8, grad=True), t(2, 2, 7, 8, grad=True), \
        t(2, 2, 7, 8, grad=True)
    lse, delta = t(2, 2, 5, f32=True), t(2, 2, 5, f32=True)
    x4, w4 = t(2, 5, 6, 7, grad=True), t(3, 3, 3, 4, grad=True, scale=0.2)
    y5 = t(2, 5, 6, 7, 4)
    c4, c4b = t(4, f32=True), t(4, f32=True, scale=0.1)
    x5, w5 = t(2, 4, 5, 6, 3, grad=True), t(3, 3, 3, 3, 5, grad=True,
                                            scale=0.2)
    gy5, y55 = t(2, 4, 5, 6, 5), t(2, 4, 5, 6, 5)
    c5, c5b = t(5, f32=True), t(5, f32=True, scale=0.1)
    yp = t(2, 5, 4, 7, 3, grad=True)
    # K14: a 4x5x3 grid, window 3 (z clamped: no shift there), 2 heads
    geo = ([3, 3, 3], [1, 1, 0], [3, 3, 3], 0.25)
    qkv, qkv_b = t(2, 4, 5, 3, 96, grad=True), t(96, grad=True, scale=0.5)
    table = t(125, 2, f32=True, grad=True, scale=0.5)
    w_out, w_lse = wa.window_attention_reference(
        *(a.detach().cpu() for a in (qkv, qkv_b, table)), *geo)
    cases = [
        (pooling.token_pool_op, (t(2, 5, 8, grad=True), t(2, 5, 8,
                                                          grad=True))),
        (fa.attention_op, (q, k, v, 0.3)),
        (fa.flash_fwd_op, (q, k, v, 0.3)),
        (fa.flash_dq_op, (q.detach(), k.detach(), v.detach(),
                          t(2, 2, 5, 8), lse, delta, 0.3)),
        (fa.flash_dkv_op, (q.detach(), k.detach(), v.detach(),
                           t(2, 2, 5, 8), lse, delta, 0.3)),
        (stem.stem_conv_op, (x4, w4)),
        (stem.stem_conv_stats_op, (x4, w4)),
        (stem.stem_dw_op, (x4.detach(), y5, t(2, 5, 6, 7, 4), c4, c4b)),
        (band_conv.band_conv_op, (x5, w5)),
        (band_conv.band_conv_stats_op, (x5, w5)),
        (band_conv.band_dw_op, (x5.detach(), gy5)),
        (band_conv.band_dw_op, (x5.detach(), gy5, y55, c5, c5b)),
        (wa.window_attention_op, (qkv, qkv_b, table, *geo)),
        (wa.window_attention_bwd_op,
         (qkv.detach(), qkv_b.detach(), table.detach(), w_out.to(device),
          w_lse.to(device), t(*w_out.shape), *geo)),
    ]
    for mode, lanes in pools:
        n = 7 * 3 if lanes else 3
        s = (1.0 + 0.5 * t(n, f32=True)).requires_grad_()
        b = (0.3 * t(n, f32=True)).requires_grad_()
        args = (0.01, mode, lanes, mode == "max" and lanes)
        p = pool3d.affine_act_pool_reference(yp.detach().cpu(),
                                             s.detach().cpu(),
                                             b.detach().cpu(), 0.01,
                                             mode).to(device)
        cases += [
            (pool3d.affine_act_pool_op, (yp, s, b, *args)),
            (pool3d.affine_act_pool_bwd_op,
             (yp.detach(), s.detach(), b.detach(), p, t(*p.shape), *args))]
    return cases


def _ids():
    return [f"{op._opname}" for op, _ in _cases(torch.Generator(), F32)]


def test_every_kernel_has_one_op():
    """Fifteen ops, one namespace: K8 with and without its sums, K14's
    forward and backward, the rest one a kernel; each module's kernels are
    reached through them."""
    assert sorted(op._opname for op in _build.OPS) == sorted([
        "token_pool", "attention", "stem_conv", "affine_act_pool",
        "stem_conv_stats", "stem_dw", "affine_act_pool_bwd", "band_conv",
        "band_conv_stats", "band_dw", "flash_fwd", "flash_dq", "flash_dkv",
        "window_attention", "window_attention_bwd"])
    assert {op.namespace for op in _build.OPS} == {"transmf"}
    assert {op._opname for op, _ in _cases(torch.Generator(), F32)} == {
        op._opname for op in _build.OPS}


def test_no_autograd_function_left():
    """Gradients are the ops' registered autograd formulas: no
    `torch.autograd.Function` subclass remains in `ops/`."""
    for path in OPS_DIR.glob("*.py"):
        assert not re.search(r"autograd\.Function\b", path.read_text()), path


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("index", range(len(_ids())), ids=_ids())
def test_opcheck_cpu(index, dtype):
    op, args = _cases(torch.Generator().manual_seed(index), dtype)[index]
    torch.library.opcheck(op, args)


def test_meta_tensors_raise():
    """A meta tensor stands for a device without the kernels: the op
    raises, while FakeTensors get shapes from the fake implementation."""
    x = torch.ones(2, 5, 8, device="meta")
    with pytest.raises(ValueError, match="expected CUDA tensors, got meta"):
        pooling.token_pool_op(x, x)
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        y = torch.empty(2, 5, 8)
        out = pooling.token_pool_op(y, y)
    assert out.shape == (2, 32) and out.dtype == F32


def test_dispatch_counts_no_cpu_launch():
    """The CPU implementation is the plain version: no launch counted."""
    from transmf_ad_tpu_torch.ops import KERNELS, reset_launch_counts

    reset_launch_counts()
    for op, args in _cases(torch.Generator().manual_seed(0), F32):
        op(*args)
    assert all(k.launches == 0 for k in KERNELS)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
def test_opcheck_cuda(dtype):
    """Each op against its kernel on the card: the fake implementation's
    shapes, dtypes and strides, no aliasing, the autograd registration."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    for op, args in _cases(torch.Generator().manual_seed(1), dtype, "cuda"):
        torch.library.opcheck(op, args)
