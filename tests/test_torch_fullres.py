"""The encoder on the full-resolution route, port against JAX, float32 CPU.

At 182x218x182 the JAX package sends the two stage-2 convs through its banded
Pallas kernel and their stage end through the lane-vector pool. Here that
route is forced at a small volume on both sides: the port with
`band_min_voxels=0`, the JAX package with `use_pallas=True` and
`TRANSMF_BAND_CONV=all` (`tests/_torch_parity.py::band_route`), so every
3x3x3 body conv takes it. JAX runs its Pallas kernels in interpret mode; the
port runs its plain versions.

Tolerance: 1e-4 of max(1, the tensor's largest magnitude), as in
tests/test_torch_train.py.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import band_route, randomize_bn
from tests._torch_parity import unit_scale_close as _scale_close
from transmf_ad_tpu import nn as jnn
from transmf_ad_tpu_torch import nn as tnn
from transmf_ad_tpu_torch.utils.weights import snet_state_dict

DIM = 24  # SNet widths 6, 6, 12, 12, 24, 48 (see `band_route` for why)


@pytest.fixture(scope="module")
def band_calls():
    with band_route() as calls:
        yield calls


@pytest.fixture(scope="module")
def snet(band_calls):
    """(JAX SNet on the band route, its randomised variables, the port's
    SNet with the same weights)."""
    x = jnp.zeros((1, 16, 16, 16, 1), jnp.float32)
    v = jax.jit(jnn.SNet(dim=DIM, use_pallas=False).init)(
        jax.random.key(3), x)
    v = randomize_bn(v, seed=5)
    port = tnn.SNet(DIM, band_min_voxels=0)
    sd = snet_state_dict(v["params"], v["batch_stats"], "e")
    port.load_state_dict({k[2:]: t for k, t in sd.items()}, strict=True)
    return jnn.SNet(dim=DIM, use_pallas=True), v, port


def _volume(seed, b=3):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, 19, 21, 18, 1)).astype(np.float32)


def test_snet_eval_band_route(snet, band_calls):
    jnet, v, port = snet
    x = _volume(1)
    n = len(band_calls)
    ref = jax.jit(jnet.apply)(v, jnp.asarray(x))
    assert len(band_calls) == n + 5  # every 3x3x3 body conv
    with torch.inference_mode():
        out = port(torch.from_numpy(x))
    assert out.shape == ref.shape == (3, 1, 1, 1, DIM)
    _scale_close(out.numpy(), ref, "features")


@pytest.mark.parametrize("masked", [False, True])
def test_snet_train_band_route(snet, band_calls, masked):
    """Training mode: the features, every parameter gradient and every
    running statistic; with a `bn_mask`, the band conv runs without its
    sums and the moments are mask-weighted."""
    jnet, v, port = snet
    port = copy.deepcopy(port)
    x = _volume(2)
    cot = np.random.default_rng(3).standard_normal(
        (3, 1, 1, 1, DIM)).astype(np.float32)
    mask = np.array([1.0, 0.0, 1.0], np.float32) if masked else None
    jmask = None if mask is None else jnp.asarray(mask)

    def loss(params):
        out, upd = jnet.apply({"params": params,
                               "batch_stats": v["batch_stats"]},
                              jnp.asarray(x), True, jmask,
                              mutable=["batch_stats"])
        return jnp.sum(out * jnp.asarray(cot)), (out, upd["batch_stats"])

    n = len(band_calls)
    (_, (ref, stats)), grads = jax.jit(
        jax.value_and_grad(loss, has_aux=True))(v["params"])
    # forward and dx of five convs (the first conv's dx included: its input
    # is the stem's pooled output)
    assert len(band_calls) == n + 10
    out = port(torch.from_numpy(x), True,
               None if mask is None else torch.from_numpy(mask))
    _scale_close(out.detach().numpy(), ref, "features")
    out.backward(torch.from_numpy(cot))
    want = {k[2:]: t for k, t in snet_state_dict(grads, stats, "e").items()}
    got = dict(port.state_dict())
    got.update({k: p.grad for k, p in port.named_parameters()})
    assert got.keys() == want.keys()
    for k in want:
        _scale_close(got[k].numpy(), want[k].numpy(), k)
