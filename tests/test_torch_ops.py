"""Port ops (transmf_ad_tpu_torch.ops) against the JAX package's ops.

The same numpy-seeded inputs go through the JAX op with its Pallas kernel
in interpret mode and through the port's plain path (CPU tensors), in
float32 unless stated. Shapes have odd tails. Tolerances: float32 results
differ in the order of float32 sums (1e-5 absolute at O(1) values); the
affine y * s + b differs by one float32 ulp where XLA contracts it into a
fused multiply-add and the port rounds the product (1e-6 at O(1) values).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmf_ad_tpu.nn.batchnorm import bn_affine_reference as j_bn_affine
from transmf_ad_tpu.ops import attention_core as j_attention_core
from transmf_ad_tpu.ops import pool3d as j_pool3d
from transmf_ad_tpu.ops import pooling as j_pooling
from transmf_ad_tpu.ops import stem as j_stem
from transmf_ad_tpu.ops.flash_attention import \
    fused_attention as j_fused_attention
from transmf_ad_tpu_torch.ops import attention_core, pool3d, pooling, stem
from transmf_ad_tpu_torch.ops.flash_attention import fused_attention


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(port, ref, atol=1e-5, rtol=1e-5):
    np.testing.assert_allclose(port.float().numpy(), _np(ref), atol=atol,
                               rtol=rtol)


def test_fused_token_pool(rng):
    mri = rng.standard_normal((2, 13, 8)).astype(np.float32)
    pet = rng.standard_normal((2, 13, 8)).astype(np.float32)
    ref = j_pooling.fused_token_pool(jnp.asarray(mri), jnp.asarray(pet),
                                     True, True)
    out = pooling.fused_token_pool(torch.from_numpy(mri),
                                   torch.from_numpy(pet))
    assert out.shape == (2, 32)
    _close(out, ref, atol=1e-6)


@pytest.mark.parametrize("n,m", [(13, 19), (37, 150)])
def test_fused_attention(rng, n, m):
    q = rng.standard_normal((2, 2, n, 8)).astype(np.float32)
    k = rng.standard_normal((2, 2, m, 8)).astype(np.float32)
    v = rng.standard_normal((2, 2, m, 8)).astype(np.float32)
    scale = 8 ** -0.5
    ref = j_fused_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            scale, True)
    out = fused_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), scale)
    _close(out, ref)
    ref_core = j_attention_core(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), scale, use_pallas=True)
    out_core = attention_core(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), scale)
    _close(out_core, ref_core)


def test_stem_conv(rng):
    x = rng.standard_normal((2, 7, 9, 11)).astype(np.float32)
    w = (0.3 * rng.standard_normal((3, 3, 3, 4))).astype(np.float32)
    ref = j_stem.stem_conv(jnp.asarray(x), jnp.asarray(w), True, True)
    out = stem.stem_conv(torch.from_numpy(x), torch.from_numpy(w))
    assert out.shape == (2, 7, 9, 11, 4)
    _close(out, ref)


def _pool_inputs(rng, lanes, dtype=np.float32):
    y = rng.standard_normal((2, 7, 9, 11, 4)).astype(dtype)
    n = 11 * 4 if lanes else 4
    s = (1.0 + 0.5 * rng.standard_normal(n)).astype(np.float32)
    b = (0.3 * rng.standard_normal(n)).astype(np.float32)
    return y, s, b


@pytest.mark.parametrize("slope", [0.01, 1.0])
def test_max_pool_affine_act_lanes(rng, slope):
    y, s, b = _pool_inputs(rng, lanes=True)
    ref = j_pool3d.max_pool3d_2x2_affine_act(
        jnp.asarray(y), jnp.asarray(s), jnp.asarray(b), slope, True, True)
    out = pool3d.max_pool3d_2x2_affine_act(
        torch.from_numpy(y), torch.from_numpy(s), torch.from_numpy(b), slope)
    assert out.shape == (2, 3, 4, 5, 4)
    _close(out, ref, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("slope", [0.01, 1.0])
def test_max_pool_affine_act_bc(rng, slope):
    y, s, b = _pool_inputs(rng, lanes=False)
    ref = j_pool3d.max_pool3d_2x2_affine_act_bc(
        jnp.asarray(y), jnp.asarray(s), jnp.asarray(b), slope, True, True)
    out = pool3d.max_pool3d_2x2_affine_act_bc(
        torch.from_numpy(y), torch.from_numpy(s), torch.from_numpy(b), slope)
    _close(out, ref, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("slope", [0.01, 1.0])
def test_avg_pool_affine_act(rng, slope):
    """The stage-4 end: JAX applies the affine + act unfused, then its
    Pallas mean pool; the port fuses both into one call."""
    y, s, b = _pool_inputs(rng, lanes=False)
    z = j_bn_affine(jnp.asarray(y), jnp.asarray(s), jnp.asarray(b), slope)
    ref = j_pool3d.avg_pool3d_2x2(z, True, True)
    out = pool3d.avg_pool3d_2x2_affine_act(
        torch.from_numpy(y), torch.from_numpy(s), torch.from_numpy(b), slope)
    _close(out, ref, atol=1e-6)


@pytest.mark.parametrize("mode", ["max", "avg"])
def test_plain_pool(rng, mode):
    x = rng.standard_normal((2, 7, 9, 11, 4)).astype(np.float32)
    j_fn = (j_pool3d.max_pool3d_2x2 if mode == "max"
            else j_pool3d.avg_pool3d_2x2)
    port_fn = (pool3d.max_pool3d_2x2 if mode == "max"
               else pool3d.avg_pool3d_2x2)
    ref = j_fn(jnp.asarray(x), True, True)
    out = port_fn(torch.from_numpy(x))
    _close(out, ref, atol=0 if mode == "max" else 1e-6, rtol=0)


@pytest.mark.parametrize("lanes", [True, False])
def test_max_pool_affine_act_bf16_exact(rng, lanes):
    """bfloat16: the activation is rounded to bf16 before the max, so the
    pooled values are bf16 values that both sides must select exactly."""
    y, s, b = _pool_inputs(rng, lanes)
    yj = jnp.asarray(y).astype(jnp.bfloat16)
    yt = torch.from_numpy(y).to(torch.bfloat16)
    if lanes:
        ref = j_pool3d.max_pool3d_2x2_affine_act(
            yj, jnp.asarray(s), jnp.asarray(b), 0.01, True, True)
        out = pool3d.max_pool3d_2x2_affine_act(
            yt, torch.from_numpy(s), torch.from_numpy(b), 0.01)
    else:
        ref = j_pool3d.max_pool3d_2x2_affine_act_bc(
            yj, jnp.asarray(s), jnp.asarray(b), 0.01, True, True)
        out = pool3d.max_pool3d_2x2_affine_act_bc(
            yt, torch.from_numpy(s), torch.from_numpy(b), 0.01)
    assert ref.dtype == jnp.bfloat16 and out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().numpy(), _np(ref))
