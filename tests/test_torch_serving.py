"""Port serving (`make_inference_fn`) against the JAX package's, float32 CPU.

See tests/_torch_parity.py for how weights, inputs and tolerances are made.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import close, model, model_ad, volumes
from transmf_ad_tpu import serving as j_serving
from transmf_ad_tpu_torch import nn as tnn
from transmf_ad_tpu_torch.serving import make_inference_fn

model_ad = pytest.fixture(scope="module")(model_ad)


def test_make_inference_fn(model_ad):
    jmodel, v, port = model_ad
    state = types.SimpleNamespace(params=v["params"],
                                  batch_stats=v["batch_stats"],
                                  apply_fn=jmodel.apply)
    j_infer = jax.jit(
        j_serving.make_inference_fn(state, ("MRI", "PET"), True))
    infer = make_inference_fn(port, "cpu", "auto")
    mri, pet = volumes(6)
    ref = j_infer(jnp.asarray(mri), jnp.asarray(pet))
    probs = infer(mri, pet)
    assert probs.dtype == torch.float32 and probs.shape == (2, 2)
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, atol=1e-6)
    close(probs, ref)


@pytest.mark.parametrize("name", ["transformer", "transformer_res"])
def test_make_inference_fn_plain_logits(name):
    """A model that returns plain logits serves (B, 2) probabilities for
    every sample of the batch, not the first sample's logits; whether a
    model is adversarial is read from the registry."""
    jmodel, v, port = model(name)
    state = types.SimpleNamespace(params=v["params"],
                                  batch_stats=v["batch_stats"],
                                  apply_fn=jmodel.apply)
    j_infer = jax.jit(
        j_serving.make_inference_fn(state, ("MRI", "PET"), False))
    rng = np.random.default_rng(7)
    mri, pet = (rng.standard_normal((3, 35, 37, 33)).astype(np.float32)
                for _ in range(2))
    probs = make_inference_fn(port, "cpu")(mri, pet)
    assert probs.dtype == torch.float32 and probs.shape == (3, 2)
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, atol=1e-6)
    assert not torch.equal(probs[0], probs[1])
    close(probs, j_infer(jnp.asarray(mri), jnp.asarray(pet)))


def test_make_inference_fn_adversarial_flag():
    """The flag overrides the registry, and a model the registry does not
    hold needs it."""
    _, _, port = model("transformer_res")
    mri, pet = volumes(6)
    with pytest.raises(ValueError, match="not a registered model"):
        make_inference_fn(tnn.SNet(16), "cpu")
    plain = make_inference_fn(port, "cpu", adversarial=False)(mri, pet)
    torch.testing.assert_close(make_inference_fn(port, "cpu")(mri, pet),
                               plain, rtol=0, atol=0)
    # read as a triple, the (2, 2) logits would lose their batch axis
    assert make_inference_fn(port, "cpu", adversarial=True)(
        mri, pet).shape == (2,)


@pytest.mark.parametrize("count", [1, 3])
def test_make_inference_fn_wrong_volume_count(count):
    """The closure takes *vols, as the JAX package's does: a wrong number
    of volumes reaches the model's forward and raises a TypeError there,
    in both packages."""
    jmodel, v, port = model("transformer_res")
    state = types.SimpleNamespace(params=v["params"],
                                  batch_stats=v["batch_stats"],
                                  apply_fn=jmodel.apply)
    vols = [*volumes(6), volumes(7)[0]][:count]
    with pytest.raises(TypeError):
        j_serving.make_inference_fn(state, ("MRI", "PET"), False)(
            *[jnp.asarray(x) for x in vols])
    with pytest.raises(TypeError, match="pet" if count == 1 else "train"):
        make_inference_fn(port, "cpu")(*vols)
