"""Shared set-up of the parity tests between the port and the JAX package.

JAX variables are initialised with use_pallas=False (the same parameter
tree, much faster to trace) and applied, jitted, with use_pallas=True, so
every Pallas kernel on the path runs in interpret mode. BN affines and running
statistics are randomised, so eval BN is far from the identity. The port
gets the same weights through `state_dict_from_jax`. Tolerance: 1e-4 at
O(1) outputs; both sides compute in float32 and differ in the order of
float32 sums and in fused multiply-adds, through up to 7 conv blocks and 4
transformer layers.
"""

import contextlib

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from transmf_ad_tpu import ops as j_ops
from transmf_ad_tpu.models import build_model as j_build_model
from transmf_ad_tpu.ops import band_conv as j_band
from transmf_ad_tpu_torch import ops as t_ops
from transmf_ad_tpu_torch.models import build_model
from transmf_ad_tpu_torch.ops import flash_attention as t_flash
from transmf_ad_tpu_torch.utils.weights import state_dict_from_jax

SHAPE = (2, 35, 37, 33)  # odd tails at every pooling stage
SMALL = dict(dim=16, depth=2, heads=2, dim_head=8, mlp_dim=32)
ATOL = RTOL = 1e-4
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def randomize_bn(variables, seed=0):
    """Random BN scale/bias and running mean/var, from a numpy seed."""
    rng = np.random.default_rng(seed)
    out = {}
    for col, tree in variables.items():
        flat = traverse_util.flatten_dict(tree)
        for path, v in flat.items():
            if not any(p.startswith("BatchNorm") for p in path):
                continue
            draw = {"scale": lambda n: rng.uniform(0.5, 1.5, n),
                    "bias": lambda n: rng.normal(0.0, 0.1, n),
                    "mean": lambda n: rng.normal(0.0, 0.2, n),
                    "var": lambda n: rng.uniform(0.5, 2.0, n)}[path[-1]]
            flat[path] = jnp.asarray(draw(v.shape), jnp.float32)
        out[col] = traverse_util.unflatten_dict(flat)
    return out


def close(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               atol=ATOL, rtol=RTOL)


def scale_close(port, ref, rel, what):
    """max |port - ref| <= rel * max |ref|, compared in float32."""
    port = port.detach().float().numpy()
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    assert port.shape == ref.shape, what
    tol = rel * max(float(np.abs(ref).max()), 1e-6)
    err = float(np.abs(port - ref).max())
    assert err <= tol, f"{what}: {err} > {tol}"


def unit_scale_close(port, ref, what):
    """max |port - ref| <= 1e-4 * max(1, max |ref|) for numpy arrays."""
    port, ref = np.asarray(port), np.asarray(ref)
    tol = 1e-4 * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(port - ref).max())
    assert err <= tol, f"{what}: {err} > {tol}"


@contextlib.contextmanager
def band_route(min_voxels=None):
    """Send the JAX package's 3x3x3 body convs through its banded Pallas
    kernel (given `use_pallas=True`): all of them, or with `min_voxels`
    those over at least that many voxels. Yields a list that grows by one
    input shape per call of the kernel's entry, so a test can show that the
    route was taken.

    Models built under it should differ in their fields from those of the
    other test files: flax modules with equal fields share JAX's trace
    cache within a process, and a trace made without these environment
    variables would not take the band route."""
    calls = []
    inner = j_band._band_conv_pallas

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return inner(*a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        if min_voxels is None:
            mp.setenv("TRANSMF_BAND_CONV", "all")
        else:
            mp.setenv("TRANSMF_BAND_CONV", "1")
            mp.setenv("TRANSMF_BAND_CONV_MIN_VOX", str(min_voxels))
        mp.setattr(j_band, "_band_conv_pallas", spy)
        yield calls


def tols(dtype: str):
    """(values, float32 sums) tolerances of an op test, relative to the
    tensor's largest magnitude: 1e-4 in float32 (the order of the sums);
    one bfloat16 ulp for bfloat16 values, 1e-2 for float32 sums from
    bfloat16 inputs."""
    return (1e-4, 1e-4) if dtype == "float32" else (2.0 ** -7, 1e-2)


def volumes(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(SHAPE).astype(np.float32) for _ in range(2)]


def model(name, port_kw=None, **overrides):
    """(JAX model `name` with Pallas on, randomised variables, port model
    with the same weights); test modules wrap it as a module-scoped fixture.
    `overrides` (e.g. head_dropout) go to both models, `port_kw` (e.g.
    band_min_voxels) to the port's alone."""
    kw = dict(SMALL, **overrides)
    # the parameter tree does not depend on the volume size: initialise on
    # the smallest volume that survives the four 2x poolings
    x = jnp.zeros((1, 16, 16, 16, 1), jnp.float32)
    v = jax.jit(j_build_model(name, use_pallas=False, **kw).init)(
        jax.random.key(2), x, x)
    v = randomize_bn(v, seed=4)
    port = build_model(name, **kw, **(port_kw or {}))
    port.load_state_dict(state_dict_from_jax(v, name), strict=True)
    return j_build_model(name, use_pallas=True, **kw), v, port


def zoo_model(name, shape, port, **jax_kw):
    """(JAX model `name` with Pallas on, its randomised variables
    initialised on (1, *shape, 1) volumes, `port` loaded with the same
    weights) for the models whose parameters depend on the volume (ADVIT,
    Mnet) or that take one volume (single). `jax_kw` go to the JAX
    build_model."""
    x = jnp.zeros((1, *shape, 1), jnp.float32)
    xs = (x,) if name == "single" else (x, x)
    v = jax.jit(j_build_model(name, use_pallas=False, **jax_kw).init)(
        jax.random.key(2), *xs)
    v = randomize_bn(v, seed=4)
    port.load_state_dict(state_dict_from_jax(v, name), strict=True)
    return j_build_model(name, use_pallas=True, **jax_kw), v, port


def model_ad(port_kw=None, **overrides):
    """`model("ad", ...)`."""
    return model("ad", port_kw, **overrides)


@contextlib.contextmanager
def flash_route(min_keys):
    """Lower the key count above which `attention_core` takes the flash
    kernels, in the JAX package (read when a function is traced: trace
    under it, through a fresh `jax.jit`) and in the port. Yields a list
    that grows by "jax" or "port" per flash forward, so a test can show
    that the route was taken."""
    calls = []
    j_inner, inner = j_ops.flash_attention, t_flash.flash_fwd

    def j_spy(*a, **kw):
        calls.append("jax")
        return j_inner(*a, **kw)

    def spy(*a, **kw):
        calls.append("port")
        return inner(*a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_ops, "FLASH_MIN_KEYS", min_keys)
        mp.setattr(t_ops, "FLASH_MIN_KEYS", min_keys)
        mp.setattr(j_ops, "flash_attention", j_spy)
        mp.setattr(t_flash, "flash_fwd", spy)
        yield calls


class _NoDropout(flax.linen.Module):
    """flax Dropout's signature, returning its input."""
    rate: float = 0.0
    broadcast_dims: tuple = ()
    deterministic: bool = None

    def __call__(self, x, deterministic=None, rng=None):
        return x


@contextlib.contextmanager
def no_dropout():
    """Every flax Dropout the JAX package builds while a function is traced
    under it passes its input through: the baselines hard-code their rates
    (ADVIT's ViT 0.1, Mnet's head 0.5), and a train-mode forward can only
    be held against the port's with both sides' dropout off. Trace through
    a fresh `jax.jit`."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen, "Dropout", _NoDropout)
        yield


def train_grads(jmodel, v, port, inputs, name, seed=0, draws=0,
                eps=1e-6, out_shape=None):
    """A train-mode forward (BatchNorm batch statistics) of the JAX model
    (traced under `no_dropout`) and of the port model (built with its
    dropout 0) on the same float32 `inputs`, and the gradients of
    sum(logits * w) for a seeded w of `out_shape` ((B, 2) by default).
    `name`: the model's `state_dict_from_jax` key, or a function of the
    JAX variables giving the port's state_dict. Returns (JAX logits, port logits, JAX
    {name: gradient or updated running statistic}, the port's, {name: the
    largest distance of a JAX result on inputs multiplied by (1 + eps *
    N(0, 1)) from the unperturbed one, over `draws` such inputs}), the
    dicts under the port's state_dict names, "logits" included. The spread
    measures how far float32 rounding alone moves each result (the
    conditioning rule of `tests/test_torch_fullres_step.py`)."""
    to_port = (name if callable(name) else
               lambda tree: state_dict_from_jax(tree, name))
    w = np.random.default_rng(seed).standard_normal(
        out_shape or (inputs[0].shape[0], 2)).astype(np.float32)

    def loss(params, *xs):
        out, upd = jmodel.apply({"params": params,
                                 "batch_stats": v["batch_stats"]}, *xs,
                                train=True, mutable=["batch_stats"])
        return jnp.sum(out * w), (out, upd["batch_stats"])

    with no_dropout():
        fn = jax.jit(jax.grad(loss, has_aux=True))

        def run(xs):
            grads, (out, stats) = fn(v["params"], *map(jnp.asarray, xs))
            res = to_port({"params": grads, "batch_stats": stats})
            res["logits"] = torch.from_numpy(np.array(out))
            return res

        ref = run(inputs)
        rng = np.random.default_rng(seed + 1)
        spread = {k: 0.0 for k in ref}
        for _ in range(draws):
            other = run([x * (1 + eps * rng.standard_normal(x.shape))
                         .astype(np.float32) for x in inputs])
            for k in ref:
                spread[k] = max(spread[k],
                                float((other[k] - ref[k]).abs().max()))
    got_out = port(*(torch.from_numpy(x) for x in inputs), train=True)
    (got_out * torch.from_numpy(w)).sum().backward()
    got = {k: p.grad for k, p in port.named_parameters()}
    got.update((k, b) for k, b in port.named_buffers() if "running" in k)
    got["logits"] = got_out.detach()
    assert got.keys() == ref.keys()
    return ref, got, spread


def hold_train_grads(ref, got, spread, slack=3.0):
    """Each of `train_grads`' results within 1e-4 of max(1, its largest
    magnitude) plus `slack` times its spread."""
    for k, r in ref.items():
        r = r.numpy()
        tol = 1e-4 * max(1.0, float(np.abs(r).max())) + slack * spread[k]
        err = float(np.abs(got[k].numpy() - r).max())
        assert err <= tol, (  # a NaN fails too
            f"{k}: {err} > {tol} (of which {slack} x {spread[k]} from the "
            "perturbed inputs)")
