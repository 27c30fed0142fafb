"""The port's library pieces against the JAX package's, float32 CPU, on
seeded random inputs, within 1e-5 of max(1, the value's magnitude):
`adversarial_loss` (also with a mask, against the masked means the train
step takes), `supcon_loss` (labels, a mask or neither; 'all' and 'one'
contrast; features of more than 3 dims; both raising cases),
`fa_loss`, `PositionalEncoding1D` (odd and even widths) and
`Attention(kv_include_self=True)` (K2's plain version here; the JAX side
in interpret mode), with its gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmf_ad_tpu import nn as jnn
from transmf_ad_tpu_torch import nn as tnn

TOL = 1e-5


def _close(got, want):
    got, want = np.asarray(got.detach()), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("seed", [0, 1])
def test_adversarial_loss(seed):
    rng = np.random.default_rng(seed)
    d_mri, d_pet = (rng.standard_normal((5, 2)).astype(np.float32) * 3
                    for _ in range(2))
    got = tnn.adversarial_loss(torch.from_numpy(d_mri),
                               torch.from_numpy(d_pet))
    _close(got, jnn.adversarial_loss(jnp.asarray(d_mri), jnp.asarray(d_pet)))
    mask = np.array([1, 1, 0, 1, 0], np.float32)
    got = tnn.adversarial_loss(torch.from_numpy(d_mri),
                               torch.from_numpy(d_pet),
                               torch.from_numpy(mask))
    real = mask > 0
    _close(got, jnn.adversarial_loss(jnp.asarray(d_mri[real]),
                                     jnp.asarray(d_pet[real])))


@pytest.mark.parametrize("mode", ["all", "one"])
@pytest.mark.parametrize("given", ["labels", "mask", "none"])
def test_supcon_loss(mode, given):
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((6, 2, 3, 4)).astype(np.float32)
    feats /= np.linalg.norm(feats.reshape(6, 2, -1), axis=-1)[..., None,
                                                               None]
    labels = np.array([0, 1, 1, 0, 1, 0], np.int32)
    mask = (rng.random((6, 6)) < 0.4).astype(np.float32)
    kw = {"labels": dict(labels=labels), "mask": dict(mask=mask),
          "none": {}}[given]
    got = tnn.supcon_loss(torch.from_numpy(feats),
                          **{k: torch.from_numpy(v) for k, v in kw.items()},
                          temperature=0.1, contrast_mode=mode)
    want = jnn.supcon_loss(jnp.asarray(feats),
                           **{k: jnp.asarray(v) for k, v in kw.items()},
                           temperature=0.1, contrast_mode=mode)
    _close(got, want)


def test_supcon_loss_raises():
    feats = torch.zeros(4, 2, 3)
    with pytest.raises(ValueError, match="both"):
        tnn.supcon_loss(feats, labels=torch.zeros(4), mask=torch.eye(4))
    with pytest.raises(ValueError, match="n_views"):
        tnn.supcon_loss(torch.zeros(4, 3))
    with pytest.raises(ValueError, match="unknown mode"):
        tnn.supcon_loss(feats, contrast_mode="some")


def test_fa_loss():
    rng = np.random.default_rng(4)
    a, b = (rng.standard_normal((2, 3, 4, 3, 5)).astype(np.float32)
            for _ in range(2))
    _close(tnn.fa_loss(torch.from_numpy(a), torch.from_numpy(b)),
           jnn.fa_loss(jnp.asarray(a), jnp.asarray(b)))
    assert float(tnn.fa_loss(torch.from_numpy(a), torch.from_numpy(a))) == 0


@pytest.mark.parametrize("channels", [7, 16])
def test_positional_encoding_1d(channels):
    tokens = np.zeros((3, 11, channels), np.float32)
    got = tnn.PositionalEncoding1D(channels)(torch.from_numpy(tokens))
    want = jnn.PositionalEncoding1D(channels).apply({}, jnp.asarray(tokens))
    _close(got, want)
    assert tnn.PositionalEncoding1D(channels)(
        torch.zeros(1, 4, 2, dtype=torch.bfloat16)).dtype == torch.bfloat16


def test_attention_kv_include_self():
    """Keys and values over x followed by the context, forward and the
    gradients of the inputs."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    ctx = rng.standard_normal((2, 9, 16)).astype(np.float32)
    kw = dict(heads=2, dim_head=8)
    v = jax.jit(jnn.Attention(16, use_pallas=False, **kw).init)(
        jax.random.key(0), jnp.asarray(x), context=jnp.asarray(ctx))
    jattn = jnn.Attention(16, use_pallas=True, **kw)

    def j_out(x, ctx):
        return jattn.apply(v, x, context=ctx, kv_include_self=True)

    p = v["params"]
    port = tnn.Attention(16, **kw)
    port.load_state_dict({
        "to_q.weight": torch.from_numpy(np.array(p["to_q"]["kernel"]).T),
        "to_kv.weight": torch.from_numpy(np.array(p["to_kv"]["kernel"]).T),
        "to_out.0.weight": torch.from_numpy(
            np.array(p["to_out"]["kernel"]).T),
        "to_out.0.bias": torch.from_numpy(np.array(p["to_out"]["bias"]))},
        strict=True)
    tx, tc = (torch.from_numpy(a).requires_grad_() for a in (x, ctx))
    got = port(tx, context=tc, kv_include_self=True)
    _close(got, jax.jit(j_out)(jnp.asarray(x), jnp.asarray(ctx)))
    got.sum().backward()
    gx, gc = jax.jit(jax.grad(lambda a, b: j_out(a, b).sum(),
                              argnums=(0, 1)))(jnp.asarray(x),
                                               jnp.asarray(ctx))
    _close(tx.grad, gx)
    _close(tc.grad, gc)
    plain = port(tx, context=tc)
    assert float((plain - got).detach().abs().max()) > 1e-3
