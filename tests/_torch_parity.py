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

import jax
import jax.numpy as jnp
import numpy as np
from flax import traverse_util

from transmf_ad_tpu.models import build_model as j_build_model
from transmf_ad_tpu_torch.models import build_model
from transmf_ad_tpu_torch.utils.weights import state_dict_from_jax

SHAPE = (2, 35, 37, 33)  # odd tails at every pooling stage
SMALL = dict(dim=16, depth=2, heads=2, dim_head=8, mlp_dim=32)
ATOL = RTOL = 1e-4


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


def volumes(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(SHAPE).astype(np.float32) for _ in range(2)]


def model_ad(**overrides):
    """(JAX ModelAd with Pallas on, randomised variables, port model with
    the same weights); test modules wrap it as a module-scoped fixture.
    `overrides` (e.g. head_dropout) go to both models."""
    kw = dict(SMALL, **overrides)
    # the parameter tree does not depend on the volume size: initialise on
    # the smallest volume that survives the four 2x poolings
    x = jnp.zeros((1, 16, 16, 16, 1), jnp.float32)
    v = jax.jit(j_build_model("ad", use_pallas=False, **kw).init)(
        jax.random.key(2), x, x)
    v = randomize_bn(v, seed=4)
    port = build_model("ad", **kw)
    port.load_state_dict(state_dict_from_jax(v), strict=True)
    return j_build_model("ad", use_pallas=True, **kw), v, port
