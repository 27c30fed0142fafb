"""The JAX -> port weight bridge (`state_dict_from_jax`), float32 CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from transmf_ad_tpu.models import build_model as j_build_model
from transmf_ad_tpu.utils.torch_import import map_state_dict
from transmf_ad_tpu_torch.models import build_model
from transmf_ad_tpu_torch.utils.weights import state_dict_from_jax

SMALL = dict(dim=16, depth=2, heads=2, dim_head=8, mlp_dim=32)


@pytest.fixture(scope="module")
def variables():
    x = jnp.zeros((1, 16, 16, 16, 1), jnp.float32)
    return jax.jit(j_build_model("ad", use_pallas=False, **SMALL).init)(
        jax.random.key(0), x, x)


def test_inverse_of_map_state_dict(variables):
    """map_state_dict(state_dict_from_jax(v)) gives back v exactly."""
    params, stats = map_state_dict(state_dict_from_jax(variables), "ad")
    for got, want in ((params, variables["params"]),
                      (stats, variables["batch_stats"])):
        got, want = (traverse_util.flatten_dict(t) for t in (got, want))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                          err_msg=str(k))


@pytest.mark.parametrize("port_kw", [{}, {"band_min_voxels": 0}],
                         ids=["default", "band route"])
def test_load_state_dict_strict(variables, port_kw):
    """The band route adds no parameters: it reads the same Conv3d
    weights."""
    sd = state_dict_from_jax(variables)
    port = build_model("ad", **SMALL, **port_kw)
    assert sd.keys() == port.state_dict().keys()
    port.load_state_dict(sd, strict=True)
    w = variables["params"]["mri_cnn"]["ConvBNAct_1"]["kernel"]  # DHWIO
    np.testing.assert_array_equal(
        port.mri_cnn.conv2["0"].weight.detach().numpy(),
        np.asarray(w).transpose(4, 3, 0, 1, 2))
    d = variables["params"]["D"]["Dense_0"]["kernel"]  # (in, out)
    np.testing.assert_array_equal(port.D[0].weight.detach().numpy(),
                                  np.asarray(d).T)


def test_wrong_shape_raises(variables):
    sd = state_dict_from_jax(variables)
    sd["fc_cls.0.weight"] = torch.zeros(3, 3)
    with pytest.raises(RuntimeError, match="size mismatch"):
        build_model("ad", **SMALL).load_state_dict(sd, strict=True)
    sd = state_dict_from_jax(variables)
    del sd["D.1.running_var"]
    with pytest.raises(RuntimeError, match="Missing key"):
        build_model("ad", **SMALL).load_state_dict(sd, strict=True)


def test_unported_model_raises(variables):
    with pytest.raises(ValueError, match="only 'ad'"):
        state_dict_from_jax(variables, model="cnn_ad")
    with pytest.raises(ValueError, match="unported"):
        build_model("cnn_ad")
