"""The port's `utils/weights.py::init_weights` against the JAX package's
initializers, by the distribution of the draws (the bits differ: torch's
generator against `jax.random`).

Over SEEDS seeds of each package, per tensor of ModelAd and ModelCNNAd
(named by the JAX tree through `map_state_dict`): conv kernels He-normal
over fan_out (mean 0, std sqrt(2 / (Cout * 27))); conv biases and every
Linear weight and bias U(+-1/sqrt(fan_in)) (inside the bound, std
bound/sqrt(3)); `to_q` / `to_kv` without a bias on both sides; BatchNorm and
LayerNorm weights 1 and biases 0, running means 0 and variances 1, exactly.
A moment is held within 6 standard errors of the pooled draws (for a normal
sample the relative error of the variance is sqrt(2 / n), for a uniform one
sqrt(0.8 / n)), the port's and JAX's both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from transmf_ad_tpu.models import build_model as j_build_model
from transmf_ad_tpu.utils.torch_import import map_state_dict
from transmf_ad_tpu_torch.models import build_model
from transmf_ad_tpu_torch.utils.weights import init_weights

SEEDS = 6
ARCH = {"ad": dict(dim=32, depth=1, heads=2), "cnn_ad": dict(dim=32)}


def _port_draws(name):
    out = []
    for seed in range(SEEDS):
        m = build_model(name, **ARCH[name])
        init_weights(m, torch.Generator().manual_seed(seed))
        params, stats = map_state_dict(
            {k: t.detach() for k, t in m.state_dict().items()}, name)
        out.append({**_flat("params", params), **_flat("stats", stats)})
    return out


def _jax_draws(name):
    jm = j_build_model(name, use_pallas=False, **ARCH[name])
    x = jnp.zeros((1, 16, 16, 16, 1), jnp.float32)
    init = jax.jit(jm.init)
    out = []
    for seed in range(SEEDS):
        v = init(jax.random.key(seed), x, x)
        out.append({**_flat("params", v["params"]),
                    **_flat("stats", v["batch_stats"])})
    return out


def _flat(col, tree):
    return {(col, *k): np.asarray(v, np.float32)
            for k, v in traverse_util.flatten_dict(tree).items()}


def _rule(key, shape):
    """(kind, parameter) of a tensor's initializer, from its JAX name."""
    col, *path = key
    leaf, owner = path[-1], path[-2]
    if col == "stats":
        return "const", 0.0 if leaf == "mean" else 1.0
    if owner.startswith(("BatchNorm", "LayerNorm")):
        return "const", 1.0 if leaf == "scale" else 0.0
    if owner.startswith("ConvBNAct"):
        if leaf == "kernel":  # DHWIO
            return "normal", np.sqrt(2.0 / (shape[-1] * np.prod(shape[:3])))
        return "uniform", None  # the bias: its fan_in comes from the kernel
    return "uniform", 1.0 / np.sqrt(shape[0]) if leaf == "kernel" else None


def _fan_in_bound(draw, key):
    col, *path = key
    kernel = draw[(col, *path[:-1], "kernel")]
    fan_in = (np.prod(kernel.shape[:-1]) if kernel.ndim == 5
              else kernel.shape[0])
    return 1.0 / np.sqrt(fan_in)


@pytest.mark.parametrize("name", ["ad", "cnn_ad"])
def test_init_distributions(name):
    port, ref = _port_draws(name), _jax_draws(name)
    assert port[0].keys() == ref[0].keys()
    assert not [k for k in ref[0] if k[-2] in ("to_q", "to_kv")
                and k[-1] == "bias"]
    for key in ref[0]:
        kind, p = _rule(key, ref[0][key].shape)
        if kind == "uniform" and p is None:
            p = _fan_in_bound(ref[0], key)
        for side, draws in (("port", port), ("jax", ref)):
            x = np.stack([d[key] for d in draws]).astype(np.float64)
            assert x.shape[1:] == ref[0][key].shape, (side, key)
            if kind == "const":
                assert (x == p).all(), (side, key)
                continue
            n = x.size
            if kind == "normal":
                sd, rel = p, np.sqrt(2.0 / n)
            else:
                assert np.abs(x).max() <= p * (1 + 1e-6), (side, key)
                sd, rel = p / np.sqrt(3.0), np.sqrt(0.8 / n)
            assert abs(x.mean()) <= 6 * sd / np.sqrt(n), (side, key, "mean")
            var = (x ** 2).mean()
            assert abs(var / sd ** 2 - 1) <= 6 * rel, (side, key, "var",
                                                       var, sd ** 2)
