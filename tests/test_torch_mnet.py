"""The port's Mnet against the JAX package's, float32 CPU, with the same
weights (`state_dict_from_jax`, randomised BatchNorm statistics) at the
reduced geometry of tests/test_integration.py's Mnet run: (25, 31, 25)
volumes (odd, L % 3 == 1, so every slice branch collapses its axis to 1
as at the reference's (91, 109, 91)) and the spatial stack at kernel 3,
pool 2. Mnet at the full geometry takes JAX minutes to compile on this CPU.

Held as `tests/test_torch_advit.py` holds ADVIT: eval logits within 1e-4;
train-mode logits, every parameter gradient and every updated running
statistic within 1e-4 of max(1, its largest magnitude) plus 3 times the
spread of JAX runs on perturbed inputs. Batch 4: with 2 samples every
BatchNorm1d gradient of the head is O(eps / var), a difference of rounding.
The model launches no kernel on the card: `chip_smoke.py` phase 15 requires
zero launches there but K13's, the train step's augmentation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import (close, hold_train_grads, train_grads,
                                 zoo_model)
from transmf_ad_tpu_torch.models import Mnet, build_model

SHAPE = (25, 31, 25)
SPATIAL = dict(spatial_kernel=3, spatial_pool=2)
DRAWS = 3


@pytest.fixture(scope="module")
def mnet():
    port = Mnet(input_shape=SHAPE, head_dropout=0.0, **SPATIAL)
    return zoo_model("mnet", SHAPE, port, **SPATIAL)


def _inputs(seed, b=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, *SHAPE, 1)).astype(np.float32)
            for _ in range(2)]


def test_features_follow_the_geometry():
    """320 features a modality at the reference geometry (axial 128,
    coronal 64, sagittal 128), from the constructor's arithmetic."""
    m = build_model("mnet", dim=16, input_shape=(91, 109, 91))
    assert m.mri.features == 320 and m.fc[0].in_features == 640
    assert m.mri.slice_cnn_col.conv2["3"].kernel_size == (1, 1, 55)
    assert m.mri.spatial_cnn_sag.conv1["0"].stride == (2, 2, 2)
    assert Mnet(SHAPE, **SPATIAL).mri.features == 64 * 3 * (2 * 2)


def test_eval(mnet):
    jmodel, v, port = mnet
    mri, pet = _inputs(1, b=2)
    ref = jax.jit(lambda v, a, b: jmodel.apply(v, a, b))(
        v, jnp.asarray(mri), jnp.asarray(pet))
    with torch.inference_mode():
        got = port(torch.from_numpy(mri), torch.from_numpy(pet))
    assert got.shape == (2, 2)
    close(got, ref)


def test_train_forward_and_gradients(mnet):
    jmodel, v, port = mnet
    ref, got, spread = train_grads(jmodel, v, port, _inputs(2), "mnet",
                                   draws=DRAWS)
    hold_train_grads(ref, got, spread)
    assert float(got["pet.spatial_cnn_col.conv1.0.weight"].abs().max()) > 0


def test_too_small_a_volume_raises():
    """A plane that the spatial stack would take to nothing raises when the
    model is built (the head would otherwise have no input)."""
    with pytest.raises(ValueError, match="no voxel"):
        Mnet(input_shape=(25, 31, 25))
