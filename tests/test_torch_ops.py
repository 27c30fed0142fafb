"""Port ops (transmf_ad_tpu_torch.ops) against the JAX package's ops.

The same numpy-seeded inputs go through the JAX op with its Pallas kernel
in interpret mode and through the port's plain path (CPU tensors), in
float32 unless stated. Shapes have odd tails. Tolerances: float32 results
differ in the order of float32 sums (1e-5 absolute at O(1) values); the
affine y * s + b differs by one float32 ulp where XLA contracts it into a
fused multiply-add and the port rounds the product (1e-6 at O(1) values).
"""

import jax
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


# --- backward passes against jax.vjp of the JAX ops -------------------------

def _vjp(fn, primals, cot):
    """Cotangents of `fn` at `primals` (numpy) for the output cotangent."""
    out, pull = jax.vjp(fn, *(jnp.asarray(p) for p in primals))
    cot = jax.tree_util.tree_map(lambda o, c: jnp.asarray(c, o.dtype), out,
                                 cot)
    return pull(cot)


def _grads(fn, primals, cot, dtype=torch.float32):
    """Gradients of the port's `fn` at `primals` (numpy) for `cot`."""
    ts = [torch.from_numpy(np.asarray(p)).to(dtype if p.dtype != np.float32
                                            or dtype == torch.float32
                                            else dtype).requires_grad_()
          for p in primals]
    out = fn(*ts)
    outs = out if isinstance(out, tuple) else (out,)
    cots = cot if isinstance(cot, tuple) else (cot,)
    torch.autograd.backward(
        outs, [torch.from_numpy(np.asarray(c)).to(o.dtype)
               for o, c in zip(outs, cots)])
    return [t.grad for t in ts]


_POOL_ENTRIES = {
    # name: (port fn, JAX fn, lanes, affine)
    "lanes": (pool3d.max_pool3d_2x2_affine_act,
              lambda y, s, b, sl: j_pool3d.max_pool3d_2x2_affine_act(
                  y, s, b, sl, True, True), True),
    "bc": (pool3d.max_pool3d_2x2_affine_act_bc,
           lambda y, s, b, sl: j_pool3d.max_pool3d_2x2_affine_act_bc(
               y, s, b, sl, True, True), False),
    "avg": (pool3d.avg_pool3d_2x2_affine_act,
            lambda y, s, b, sl: j_pool3d.avg_pool3d_2x2(
                j_bn_affine(y, s, b, sl), True, True), False),
}


@pytest.mark.parametrize("entry", sorted(_POOL_ENTRIES))
def test_affine_act_pool_backward(rng, entry):
    port_fn, j_fn, lanes = _POOL_ENTRIES[entry]
    y, s, b = _pool_inputs(rng, lanes)
    g = rng.standard_normal((2, 3, 4, 5, 4)).astype(np.float32)
    ref = _vjp(lambda yy, ss, bb: j_fn(yy, ss, bb, 0.01), (y, s, b), g)
    got = _grads(lambda yy, ss, bb: port_fn(yy, ss, bb, 0.01), (y, s, b), g)
    for name, a, r in zip(("dy", "ds", "db"), got, ref):
        _close(a, r, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("mode", ["max", "avg"])
def test_plain_pool_backward(rng, mode):
    """The identity-affine entries (_pool_bwd_kernel, _avg_bwd_kernel)."""
    x = rng.standard_normal((2, 7, 9, 11, 4)).astype(np.float32)
    g = rng.standard_normal((2, 3, 4, 5, 4)).astype(np.float32)
    j_fn = (j_pool3d.max_pool3d_2x2 if mode == "max"
            else j_pool3d.avg_pool3d_2x2)
    port_fn = (pool3d.max_pool3d_2x2 if mode == "max"
               else pool3d.avg_pool3d_2x2)
    (ref,) = _vjp(lambda xx: j_fn(xx, True, True), (x,), g)
    (got,) = _grads(port_fn, (x,), g)
    _close(got, ref, atol=0, rtol=0)


@pytest.mark.parametrize("mode", ["max", "avg"])
def test_plain_pool_backward_bf16_ties(rng, mode):
    """The identity-affine entries in bfloat16 on a coarse grid, so max
    windows hold exact ties: dx matches jax.vjp bit for bit."""
    x = (rng.integers(-2, 3, (2, 5, 7, 9, 4)) * 0.5).astype(np.float32)
    g = rng.standard_normal((2, 2, 3, 4, 4)).astype(np.float32)
    j_fn = (j_pool3d.max_pool3d_2x2 if mode == "max"
            else j_pool3d.avg_pool3d_2x2)
    port_fn = (pool3d.max_pool3d_2x2 if mode == "max"
               else pool3d.avg_pool3d_2x2)
    _, pull = jax.vjp(lambda xx: j_fn(xx, True, True),
                      jnp.asarray(x, jnp.bfloat16))
    (ref,) = pull(jnp.asarray(g, jnp.bfloat16))
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    out = port_fn(xt)
    if mode == "max":
        assert int((_np(ref) != 0).sum()) > out.numel()  # ties split
    out.backward(torch.from_numpy(g).to(torch.bfloat16))
    np.testing.assert_array_equal(xt.grad.float().numpy(), _np(ref))


def _tied_inputs(rng, lanes):
    """bf16 y on a coarse grid and power-of-two affines: y * s + b is exact
    in float32 whatever the rounding mode or fused multiply-add, so the
    windows really hold ties (and the same ones on both sides)."""
    y = (rng.integers(-3, 4, (2, 5, 7, 9, 4)) * 0.5).astype(np.float32)
    n = 9 * 4 if lanes else 4
    s = (2.0 ** rng.integers(-1, 2, n)).astype(np.float32)
    b = (0.25 * rng.integers(-2, 3, n)).astype(np.float32)
    return y, s, b


@pytest.mark.parametrize("entry", sorted(_POOL_ENTRIES))
def test_affine_act_pool_backward_bf16_ties(rng, entry):
    """bfloat16 with exact ties: the gradient is split equally among tied
    maxima, with g/count rounded as the TPU kernel of each entry rounds
    it, so dy matches jax.vjp bit for bit."""
    port_fn, j_fn, lanes = _POOL_ENTRIES[entry]
    y, s, b = _tied_inputs(rng, lanes)
    g = rng.standard_normal((2, 2, 3, 4, 4)).astype(np.float32)
    yj = jnp.asarray(y, jnp.bfloat16)
    out, pull = jax.vjp(lambda yy, ss, bb: j_fn(yy, ss, bb, 0.01), yj,
                        jnp.asarray(s), jnp.asarray(b))
    ref = pull(jnp.asarray(g, jnp.bfloat16))
    yt = torch.from_numpy(y).to(torch.bfloat16).requires_grad_()
    st, bt = (torch.from_numpy(v).requires_grad_() for v in (s, b))
    pt = port_fn(yt, st, bt, 0.01)
    if entry != "avg":
        # (the TPU mean kernel adds x- and z-pairs in bfloat16; the port
        # and the JAX package's XLA path add in float32, so bf16 means may
        # differ by one ulp)
        np.testing.assert_array_equal(pt.float().detach().numpy(), _np(out))
        # ties: more window elements get gradient than there are windows
        assert int((_np(ref[0]) != 0).sum()) > pt.numel()
    pt.backward(torch.from_numpy(g).to(torch.bfloat16))
    np.testing.assert_array_equal(yt.grad.float().numpy(), _np(ref[0]))
    _close(st.grad, ref[1], atol=1e-5, rtol=1e-5)
    _close(bt.grad, ref[2], atol=1e-5, rtol=1e-5)


def test_stem_conv_stats_forward_and_backward(rng):
    """y, the per-channel sums (the JAX op's per-lane sums folded over z,
    as its caller folds them), and dw and dx for cotangents of y and of
    both sums."""
    x = rng.standard_normal((2, 7, 9, 11)).astype(np.float32)
    w = (0.3 * rng.standard_normal((3, 3, 3, 4))).astype(np.float32)
    gy = rng.standard_normal((2, 7, 9, 11, 4)).astype(np.float32)
    gst = (0.01 * rng.standard_normal((2, 4))).astype(np.float32)

    def j_fn(xx, ww):
        y, st = j_stem.stem_conv_stats(xx, ww, True, True)
        return y, st.reshape(2, 11, 4).sum(1)

    (y_ref, st_ref), pull = jax.vjp(j_fn, jnp.asarray(x), jnp.asarray(w))
    dx_ref, dw_ref = pull((jnp.asarray(gy), jnp.asarray(gst)))
    xt, wt = (torch.from_numpy(v).requires_grad_() for v in (x, w))
    y, st = stem.stem_conv_stats(xt, wt)
    _close(y.detach(), y_ref)
    _close(st.detach(), st_ref, rtol=1e-5, atol=1e-4)
    torch.autograd.backward((y, st), (torch.from_numpy(gy),
                                      torch.from_numpy(gst)))
    _close(wt.grad, dw_ref, rtol=1e-5, atol=1e-4)
    _close(xt.grad, dx_ref)


def test_stem_conv_backward(rng):
    """The eval stem's plain backward (a linear transpose in JAX)."""
    x = rng.standard_normal((2, 7, 9, 11)).astype(np.float32)
    w = (0.3 * rng.standard_normal((3, 3, 3, 4))).astype(np.float32)
    g = rng.standard_normal((2, 7, 9, 11, 4)).astype(np.float32)
    ref = _vjp(lambda xx, ww: j_stem.stem_conv(xx, ww, True, True), (x, w),
               g)
    got = _grads(stem.stem_conv, (x, w), g)
    for a, r in zip(got, ref):
        _close(a, r, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("ties", [False, True])
def test_fused_token_pool_backward(rng, ties):
    """g/N for the means; the max gradient split equally over tied
    argmax tokens."""
    mri = rng.standard_normal((2, 13, 8)).astype(np.float32)
    pet = rng.standard_normal((2, 13, 8)).astype(np.float32)
    if ties:
        mri = np.round(mri)  # several tokens share the column maximum
        pet[:, 5] = pet.max(axis=1) + 1.0
        pet[:, 9] = pet[:, 5]
    g = rng.standard_normal((2, 32)).astype(np.float32)
    ref = _vjp(lambda m, p: j_pooling.fused_token_pool(m, p, True, True),
               (mri, pet), g)
    got = _grads(pooling.fused_token_pool, (mri, pet), g)
    for a, r in zip(got, ref):
        _close(a, r, atol=1e-6)


def test_fused_attention_backward(rng):
    q = rng.standard_normal((2, 2, 13, 8)).astype(np.float32)
    k = rng.standard_normal((2, 2, 19, 8)).astype(np.float32)
    v = rng.standard_normal((2, 2, 19, 8)).astype(np.float32)
    g = rng.standard_normal((2, 2, 13, 8)).astype(np.float32)
    scale = 8 ** -0.5
    ref = _vjp(lambda a, b, c: j_fused_attention(a, b, c, scale, True),
               (q, k, v), g)
    got = _grads(lambda a, b, c: attention_core(a, b, c, scale), (q, k, v), g)
    for a, r in zip(got, ref):
        _close(a, r)
