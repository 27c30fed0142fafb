"""The port's band conv (`ops/band_conv.py`) against the JAX package's ops.

The same numpy-seeded inputs go through the JAX op with its Pallas kernel in
interpret mode and through the port's plain path (CPU tensors). The JAX ops
return per-lane (2, Z*C) sums that their caller folds to channels at once;
the port returns (2, C), so the JAX side is folded here the same way and the
sums' cotangents are per channel on both sides.

Tolerances (`tests/_torch_parity.py::tols`): float32 results differ in the
order of float32 sums, 1e-4 of the tensor's largest magnitude. bfloat16
values are the same float32 sum rounded once on both sides, one bfloat16 ulp
(2^-7) of the largest magnitude; float32 sums from bfloat16 inputs
(statistics, dw) 1e-2 of theirs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import JAX_DTYPES as _JAX
from tests._torch_parity import TORCH_DTYPES as _TORCH
from tests._torch_parity import scale_close as _scale_close
from tests._torch_parity import tols as _tols
from transmf_ad_tpu.ops import band_conv as j_band
from transmf_ad_tpu_torch.ops import band_conv

# (B, X, Y, Z, Cin, Cout): Cin != Cout; the second and third have a z tail
# (Z is no multiple of pick_tz_body)
_SHAPES = [(2, 5, 6, 7, 3, 8), (2, 3, 5, 13, 4, 32), (1, 4, 9, 18, 8, 16)]


def _band_inputs(rng, shape):
    B, X, Y, Z, ci, co = shape
    x = rng.standard_normal((B, X, Y, Z, ci)).astype(np.float32)
    w = (0.1 * rng.standard_normal((3, 3, 3, ci, co))).astype(np.float32)
    gy = rng.standard_normal((B, X, Y, Z, co)).astype(np.float32)
    gst = (0.05 * rng.standard_normal((2, co))).astype(np.float32)
    return x, w, gy, gst


def test_shapes_have_a_z_tail():
    tails = [Z % j_band.pick_tz_body(Z, co) != 0
             for _, _, _, Z, _, co in _SHAPES]
    assert tails == [False, True, True]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", _SHAPES)
def test_band_conv3d(rng, shape, dtype):
    """y, and dx and dw from jax.vjp against autograd."""
    x, w, gy, _ = _band_inputs(rng, shape)
    jt, tt = _JAX[dtype], _TORCH[dtype]
    val, sums = _tols(dtype)
    y_ref, pull = jax.vjp(lambda a, b: j_band.band_conv3d(a, b, True, True),
                          jnp.asarray(x, jt), jnp.asarray(w, jt))
    dx_ref, dw_ref = pull(jnp.asarray(gy, jt))
    xt = torch.from_numpy(x).to(tt).requires_grad_()
    wt = torch.from_numpy(w).to(tt).requires_grad_()
    y = band_conv.band_conv3d(xt, wt)
    assert y.dtype == tt
    _scale_close(y, y_ref, val, "y")
    y.backward(torch.from_numpy(gy).to(tt))
    _scale_close(xt.grad, dx_ref, val, "dx")
    _scale_close(wt.grad, dw_ref, sums, "dw")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", _SHAPES)
def test_band_conv3d_stats(rng, shape, dtype):
    """y, the folded sums, and dx and dw for cotangents of y and of both
    sums (the yhat assembly of the dw kernel and of the dx pass)."""
    x, w, gy, gst = _band_inputs(rng, shape)
    Z, co = shape[3], shape[5]
    jt, tt = _JAX[dtype], _TORCH[dtype]
    val, sums = _tols(dtype)

    def j_fn(a, b):
        y, st = j_band.band_conv3d_stats(a, b, True, True)
        return y, st.reshape(2, Z, co).sum(1)

    (y_ref, st_ref), pull = jax.vjp(j_fn, jnp.asarray(x, jt),
                                    jnp.asarray(w, jt))
    dx_ref, dw_ref = pull((jnp.asarray(gy, jt), jnp.asarray(gst)))
    xt = torch.from_numpy(x).to(tt).requires_grad_()
    wt = torch.from_numpy(w).to(tt).requires_grad_()
    y, st = band_conv.band_conv3d_stats(xt, wt)
    assert y.dtype == tt and st.dtype == torch.float32
    _scale_close(y, y_ref, val, "y")
    _scale_close(st, st_ref, sums, "stats")
    torch.autograd.backward((y, st), (torch.from_numpy(gy).to(tt),
                                      torch.from_numpy(gst)))
    _scale_close(xt.grad, dx_ref, val, "dx")
    _scale_close(wt.grad, dw_ref, sums, "dw")


def test_band_dw_plain_matches_autograd(rng):
    """The plain K9 (yhat written out) against autograd of the plain K8 with
    statistics: the same float32 function."""
    x, w, gy, gst = _band_inputs(rng, (2, 4, 5, 6, 3, 5))
    xt, wt = torch.from_numpy(x), torch.from_numpy(w).requires_grad_()
    y, st = band_conv.band_conv_stats_reference(xt, wt)
    torch.autograd.backward((y, st), (torch.from_numpy(gy),
                                      torch.from_numpy(gst)))
    dw = band_conv.band_dw(xt, torch.from_numpy(gy), y.detach(),
                           torch.from_numpy(gst[0]),
                           torch.from_numpy(2.0 * gst[1]))
    torch.testing.assert_close(dw, wt.grad, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="go together"):
        band_conv.band_dw(xt, torch.from_numpy(gy), y.detach())
