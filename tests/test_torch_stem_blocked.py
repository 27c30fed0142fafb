"""The port's stem at the JAX package's z-blocked (full-resolution) entries.

The JAX package chunks z for volumes that overflow the TPU's VMEM
(`stem_conv_stats_blocked`, its blocked weight gradient); the port's stem
kernels tile every volume alike, so `stem_conv_stats`, `stem_dw` and
`stem_conv` are held against the blocked JAX entries here. Set-up and
tolerances as in tests/test_torch_band.py.
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
from transmf_ad_tpu.ops import stem as j_stem
from transmf_ad_tpu_torch.ops import stem


# the blocked (z-chunked) shapes of tests/test_nn.py: divisor chunks (Z 40,
# tz 20) and the clipped tail (Z 44, tz 32)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Z", [40, 44])
def test_stem_against_blocked_stem(rng, Z, dtype):
    """`stem_conv_stats` and its `stem_dw` backward against the JAX
    package's `stem_conv_stats_blocked` and its vjp."""
    C = 32
    assert j_stem.stem_can_block(Z, C)
    assert (Z % j_stem._pick_tz(Z, C) != 0) == (Z == 44)
    jt, tt = _JAX[dtype], _TORCH[dtype]
    val, sums = _tols(dtype)
    x = rng.standard_normal((2, 5, 6, Z)).astype(np.float32)
    w = (0.1 * rng.standard_normal((3, 3, 3, C))).astype(np.float32)
    gy = rng.standard_normal((2, 5, 6, Z, C)).astype(np.float32)
    gst = (0.05 * rng.standard_normal((2, C))).astype(np.float32)

    def j_fn(a, b):
        y, st = j_stem.stem_conv_stats_blocked(a, b, True, True)
        return y, st.reshape(2, Z, C).sum(1)

    (y_ref, st_ref), pull = jax.vjp(j_fn, jnp.asarray(x, jt),
                                    jnp.asarray(w, jt))
    dx_ref, dw_ref = pull((jnp.asarray(gy, jt), jnp.asarray(gst)))
    xt = torch.from_numpy(x).to(tt).requires_grad_()
    wt = torch.from_numpy(w).to(tt).requires_grad_()
    y, st = stem.stem_conv_stats(xt, wt)
    _scale_close(y, y_ref, val, "y")
    _scale_close(st, st_ref, sums, "stats")
    torch.autograd.backward((y, st), (torch.from_numpy(gy).to(tt),
                                      torch.from_numpy(gst)))
    _scale_close(wt.grad, dw_ref, sums, "dw")
    _scale_close(xt.grad, dx_ref, val, "dx")
    # the eval entry gives the same y (the JAX package drops the sums there)
    _scale_close(stem.stem_conv(xt.detach(), wt.detach()), y_ref, val,
                 "eval y")
