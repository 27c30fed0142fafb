"""The port's flash attention against the JAX package's, on the CPU.

The JAX side runs its three Pallas kernels (forward with logsumexp, dq,
dk/dv) in interpret mode; the port runs its plain versions, which the CUDA
kernels K10-K12 are held against on the card. Inputs come from a numpy seed.
Shapes are those of tests/test_flash.py that are not marked slow.

Tolerances. Forward, float32: rtol 2e-4 / atol 2e-5, as tests/test_flash.py
holds the JAX kernel against plain attention: both sides sum in float32 in
another order (the JAX kernel block by block with a running max). The
logsumexp: 1e-5 absolute at values of O(1-10). Gradients, float32: 5e-4,
tests/test_flash.py's. bfloat16 storage: both sides compute in float32 from
the same bfloat16 inputs and round once, so they differ by at most one
bfloat16 ulp (2^-7 relative), where an output sits on a rounding boundary;
the gradients add 1e-3 of their scale, because the JAX side takes delta from
its own rounded output, which may differ from the port's by that ulp.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import JAX_DTYPES, TORCH_DTYPES
from transmf_ad_tpu import ops as j_ops
from transmf_ad_tpu_torch import ops
from transmf_ad_tpu_torch.ops import flash_attention as flash

# the module: `transmf_ad_tpu.ops.flash_attention` names the function there
j_flash = importlib.import_module("transmf_ad_tpu.ops.flash_attention")

BF16_ULP = 2.0 ** -7
# (batch, heads, queries, keys, head dim, the JAX kernel's block size)
FORWARD = [(1, 3, 300, 100, 32, 128), (2, 2, 1573, 777, 48, 256)]
GRAD = (1, 2, 700, 1100, 48, 256)


def _qkv(seed, b, h, n, m, d, dtype):
    """q, k, v as float32 numpy arrays holding values of `dtype`, and both
    sides' tensors made from them."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((b, h, n, d), (b, h, m, d), (b, h, m, d))]
    jx = [jnp.asarray(a, JAX_DTYPES[dtype]) for a in arrays]
    tx = [torch.from_numpy(a).to(TORCH_DTYPES[dtype]) for a in arrays]
    return jx, tx


def _np(t):
    return t.detach().float().numpy()


def _jnp(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("shape", FORWARD, ids=["single kv block", "cross"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_lse(shape, dtype):
    """`flash_attention` and `flash_fwd_reference` against the interpret-mode
    kernel: the output, and the logsumexp it saves for the backward."""
    b, h, n, m, d, block = shape
    scale = d ** -0.5
    (jq, jk, jv), (q, k, v) = _qkv(3, b, h, n, m, d, dtype)
    ref = j_flash.flash_attention(jq, jk, jv, scale, block, block, True)
    _, ref_lse = j_flash._flash_fwd_pallas(
        jq.reshape(b * h, n, d), jk.reshape(b * h, m, d),
        jv.reshape(b * h, m, d), scale, block, block, True)
    out, lse = flash.flash_fwd_reference(q, k, v, scale)
    assert out.dtype == q.dtype and lse.dtype == torch.float32
    assert lse.shape == (b, h, n)
    tol = (dict(rtol=2e-4, atol=2e-5) if dtype == "float32"
           else dict(rtol=BF16_ULP, atol=2e-2 * BF16_ULP))
    np.testing.assert_allclose(_np(out), _jnp(ref), **tol)
    np.testing.assert_allclose(_np(lse), _jnp(ref_lse).reshape(b, h, n),
                               rtol=0, atol=1e-5)
    # the differentiable entry returns the same output
    torch.testing.assert_close(flash.flash_attention(q, k, v, scale), out,
                               rtol=0, atol=0)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def grads(request):
    """(dtype, JAX (dq, dk, dv) from `jax.vjp` of the interpret-mode op, the
    port's from autograd through `flash_attention`) for one output
    gradient."""
    dtype = request.param
    b, h, n, m, d, block = GRAD
    scale = d ** -0.5
    (jq, jk, jv), tx = _qkv(5, b, h, n, m, d, dtype)
    g = np.random.default_rng(6).standard_normal((b, h, n, d)).astype(
        np.float32)
    _, vjp = jax.vjp(lambda q, k, v: j_flash.flash_attention(
        q, k, v, scale, block, block, True), jq, jk, jv)
    ref = vjp(jnp.asarray(g, JAX_DTYPES[dtype]))
    return dtype, ref, _autograd(flash.flash_attention, tx, scale,
                                 torch.from_numpy(g).to(TORCH_DTYPES[dtype]))


def _autograd(fn, tx, scale, g):
    leaves = [t.clone().requires_grad_() for t in tx]
    fn(*leaves, scale).backward(g)
    return [t.grad for t in leaves]


@pytest.mark.parametrize("which", [0, 1, 2], ids=["dq", "dk", "dv"])
def test_backward_through_saved_lse(grads, which):
    dtype, ref, got = grads
    a, r = _np(got[which]), _jnp(ref[which])
    assert got[which].dtype == TORCH_DTYPES[dtype] and a.shape == r.shape
    if dtype == "float32":
        np.testing.assert_allclose(a, r, rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(
        a, r, rtol=0 if dtype == "float32" else BF16_ULP,
        atol=(1e-4 if dtype == "float32" else 1e-3) * np.abs(r).max())


def test_backward_agrees_with_plain_attention():
    """The lse formula and the recomputed softmax give the same float32
    gradients (the two backward passes of the port)."""
    _, tx = _qkv(10, 2, 2, 90, 260, 24, "float32")
    g = torch.from_numpy(np.random.default_rng(11).standard_normal(
        tx[0].shape).astype(np.float32))
    for a, b in zip(_autograd(flash.flash_attention, tx, 0.2, g),
                    _autograd(flash.fused_attention, tx, 0.2, g)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_dq_and_dkv_entries_match_the_joint_backward():
    """`flash_dq` and `flash_dkv`, the entries the two kernels are checked
    through, give `flash_bwd_reference`'s gradients."""
    _, (q, k, v) = _qkv(7, 1, 2, 70, 45, 24, "float32")
    g = torch.from_numpy(np.random.default_rng(8).standard_normal(
        q.shape).astype(np.float32))
    out, lse = flash.flash_fwd(q, k, v, 0.3)
    delta = flash.flash_delta(out, g)
    assert delta.shape == lse.shape == (1, 2, 70)
    dq, dk, dv = flash.flash_bwd(q, k, v, out, lse, g, 0.3)
    torch.testing.assert_close(flash.flash_dq(q, k, v, g, lse, delta, 0.3),
                               dq, rtol=0, atol=0)
    for a, b in zip(flash.flash_dkv(q, k, v, g, lse, delta, 0.3), (dk, dv)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_attention_core_routes_by_key_count(monkeypatch):
    """Above FLASH_MIN_KEYS keys `attention_core` takes the flash path on
    both sides; at or below it the single-pass one."""
    assert ops.FLASH_MIN_KEYS == j_ops.FLASH_MIN_KEYS == 2048
    b, h, n, m, d = 1, 1, 64, 2056, 32
    (jq, jk, jv), (q, k, v) = _qkv(9, b, h, n, m, d, "float32")
    calls = []
    for mod, name in ((flash, "flash_fwd"), (flash, "_attention")):
        inner = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _n=name, _f=inner: (
            calls.append(_n), _f(*a))[1])
    out = ops.attention_core(q, k, v, d ** -0.5)
    assert calls == ["flash_fwd"]
    torch.testing.assert_close(
        out, flash.flash_fwd_reference(q, k, v, d ** -0.5)[0], rtol=0, atol=0)
    ref = j_ops.attention_core(jq, jk, jv, d ** -0.5, use_pallas=True)
    np.testing.assert_allclose(_np(out), _jnp(ref), rtol=2e-4, atol=2e-5)
    ops.attention_core(q, k[:, :, :2048], v[:, :, :2048], d ** -0.5)
    assert calls == ["flash_fwd", "_attention"]
    monkeypatch.setattr(ops, "FLASH_MIN_KEYS", 100)
    ops.attention_core(q, k[:, :, :101], v[:, :, :101], d ** -0.5)
    assert calls[-1] == "flash_fwd"
