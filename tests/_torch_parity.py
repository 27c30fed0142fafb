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

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from transmf_ad_tpu.models import build_model as j_build_model
from transmf_ad_tpu.ops import band_conv as j_band
from transmf_ad_tpu_torch.models import build_model
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


def model_ad(port_kw=None, **overrides):
    """(JAX ModelAd with Pallas on, randomised variables, port model with
    the same weights); test modules wrap it as a module-scoped fixture.
    `overrides` (e.g. head_dropout) go to both models, `port_kw` (e.g.
    band_min_voxels) to the port's alone."""
    kw = dict(SMALL, **overrides)
    # the parameter tree does not depend on the volume size: initialise on
    # the smallest volume that survives the four 2x poolings
    x = jnp.zeros((1, 16, 16, 16, 1), jnp.float32)
    v = jax.jit(j_build_model("ad", use_pallas=False, **kw).init)(
        jax.random.key(2), x, x)
    v = randomize_bn(v, seed=4)
    port = build_model("ad", **kw, **(port_kw or {}))
    port.load_state_dict(state_dict_from_jax(v), strict=True)
    return j_build_model("ad", use_pallas=True, **kw), v, port
