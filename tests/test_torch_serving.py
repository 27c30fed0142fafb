"""Port serving (`make_inference_fn`) against the JAX package's, float32 CPU.

See tests/_torch_parity.py for how weights, inputs and tolerances are made.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import close, model_ad, volumes
from transmf_ad_tpu import serving as j_serving
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
