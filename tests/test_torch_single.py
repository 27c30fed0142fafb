"""The port's ModelSingle and SFCN against the JAX package's, float32 CPU,
with the same weights (randomised BatchNorm statistics).

ModelSingle (one sNet on the MRI, averaged over space, MLP dim -> 64 -> 2)
at dim 16 on (24, 28, 24) volumes; the JAX side runs its Pallas kernels
in interpret mode. SFCN (four 3^3 ConvBNAct blocks with ReLU and a 2^3 max
pool, then a 1^3 one; the stem kernel and the pools at slope 0 in the port)
at channels (4, 8, 8, 8, 4) on (33, 35, 33) volumes, odd tails at every
pool. Held as `tests/test_torch_advit.py` holds ADVIT: eval outputs within
1e-4; train-mode outputs, every parameter gradient and every updated
running statistic within 1e-4 of max(1, its largest magnitude) plus 3
times the spread of JAX runs on perturbed inputs. Batch 4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import (close, hold_train_grads, randomize_bn,
                                 train_grads, zoo_model)
from transmf_ad_tpu.nn import SFCN as JSFCN
from transmf_ad_tpu_torch.models import SINGLE_MODALITY, build_model
from transmf_ad_tpu_torch.nn import SFCN
from transmf_ad_tpu_torch.utils import weights

SHAPE, DIM = (24, 28, 24), 16
SFCN_SHAPE, CHANNELS = (33, 35, 33), (4, 8, 8, 8, 4)
DRAWS = 3


@pytest.fixture(scope="module")
def single():
    return zoo_model("single", SHAPE, build_model("single", dim=DIM),
                     dim=DIM)


def _volume(seed, shape, b=4):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, *shape, 1)).astype(np.float32)


def test_registry():
    """Like JAX's: 'single' takes dim and the MRI alone; the head is
    fc.0 / fc.2 (dim -> 64 -> 2)."""
    m = build_model("single", dim=DIM, depth=5, heads=7, dropout=0.3)
    assert SINGLE_MODALITY == {"single"}
    assert m.cnn.conv1["0"].out_channels == DIM // 4
    assert (m.fc[0].in_features, m.fc[0].out_features,
            m.fc[2].out_features) == (DIM, 64, 2)


def test_single_eval(single):
    jmodel, v, port = single
    x = _volume(1, SHAPE, b=2)
    ref = jax.jit(lambda v, a: jmodel.apply(v, a))(v, jnp.asarray(x))
    with torch.inference_mode():
        got = port(torch.from_numpy(x))
    assert got.shape == (2, 2)
    close(got, ref)


def test_single_train_forward_and_gradients(single):
    jmodel, v, port = single
    hold_train_grads(*train_grads(jmodel, v, port, [_volume(2, SHAPE)],
                                  "single", draws=DRAWS))


def _sfcn_state_dict(variables):
    return weights._conv_bn_blocks(
        variables["params"], variables["batch_stats"],
        [(f"blocks.{i}.conv", f"blocks.{i}.bn") for i in range(5)])


@pytest.fixture(scope="module")
def sfcn():
    jm = JSFCN(channels=CHANNELS)
    x = jnp.zeros((1, *SFCN_SHAPE, 1), jnp.float32)
    v = randomize_bn(jax.jit(jm.init)(jax.random.key(3), x), seed=5)
    port = SFCN(CHANNELS)
    port.load_state_dict(_sfcn_state_dict(v), strict=True)
    return jm, v, port


def test_sfcn_eval(sfcn):
    jm, v, port = sfcn
    x = _volume(3, SFCN_SHAPE, b=2)
    ref = jax.jit(jm.apply)(v, jnp.asarray(x))
    with torch.inference_mode():
        got = port(torch.from_numpy(x))
    assert got.shape == ref.shape == (2, 2, 2, 2, 4)
    close(got, ref)


def test_sfcn_train_forward_and_gradients(sfcn):
    jm, v, port = sfcn
    ref, got, spread = train_grads(jm, v, port, [_volume(4, SFCN_SHAPE)],
                                   _sfcn_state_dict, draws=DRAWS,
                                   out_shape=(4, 2, 2, 2, 4))
    hold_train_grads(ref, got, spread)
    assert float(got["blocks.0.conv.weight"].abs().max()) > 0
