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


def _init(name):
    x = jnp.zeros((1, 16, 16, 16, 1), jnp.float32)
    return jax.jit(j_build_model(name, use_pallas=False, **SMALL).init)(
        jax.random.key(0), x, x)


@pytest.fixture(scope="module")
def variables():
    return _init("ad")


def _assert_round_trip(variables, name):
    params, stats = map_state_dict(state_dict_from_jax(variables, name), name)
    for got, want in ((params, variables["params"]),
                      (stats, variables["batch_stats"])):
        got, want = (traverse_util.flatten_dict(t) for t in (got, want))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                          err_msg=str(k))


def test_inverse_of_map_state_dict(variables):
    """map_state_dict(state_dict_from_jax(v)) gives back v exactly."""
    _assert_round_trip(variables, "ad")


@pytest.mark.parametrize("name", ["transformer", "transformer_res"])
def test_inverse_of_map_state_dict_fusion_models(name):
    """The same for the models without a discriminator; transformer_res has
    no BatchNorm in its head, so no batch_stats for it either. The port's
    model takes the result strictly."""
    v = _init(name)
    assert ("fc_cls" in v["batch_stats"]) == (name == "transformer")
    _assert_round_trip(v, name)
    sd = state_dict_from_jax(v, name)
    port = build_model(name, **SMALL)
    assert sd.keys() == port.state_dict().keys()
    assert not any(k.startswith("D.") for k in sd)
    port.load_state_dict(sd, strict=True)
    last = {"transformer": "8", "transformer_res": "6"}[name]
    np.testing.assert_array_equal(
        port.fc_cls[int(last)].weight.detach().numpy(),
        np.asarray(v["params"]["fc_cls"]["Dense_2"]["kernel"]).T)


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
    """All eight models are ported: a name outside the registry raises in
    the bridge and in build_model, as in the JAX package's."""
    for name in ("sfcn", "vit", "model_ad"):
        with pytest.raises(ValueError, match="unknown model"):
            state_dict_from_jax(variables, model=name)
        with pytest.raises(ValueError, match="unknown model"):
            build_model(name)
        with pytest.raises(ValueError, match="unknown model"):
            j_build_model(name)


# the baselines' JAX keywords and the volume their JAX init sees (their
# trees depend on it: ADVIT's token count, Mnet's head width)
ZOO = {"single": (dict(dim=16), (16, 16, 16)),
       "advit": ({}, (32, 32, 79)),
       "mnet": (dict(spatial_kernel=3, spatial_pool=2), (25, 31, 25))}


@pytest.mark.parametrize("name", sorted(ZOO))
def test_inverse_of_map_state_dict_zoo(name):
    """ModelSingle, ADVIT and Mnet: the round trip through JAX's
    map_state_dict gives back the variables exactly, and the port's model
    built for the same volume takes the state_dict strictly."""
    kw, shape = ZOO[name]
    x = jnp.zeros((1, *shape, 1), jnp.float32)
    xs = (x,) if name == "single" else (x, x)
    v = jax.jit(j_build_model(name, use_pallas=False, **kw).init)(
        jax.random.key(0), *xs)
    _assert_round_trip(v, name)
    sd = state_dict_from_jax(v, name)
    port = build_model(name, input_shape=shape, **kw)
    assert sd.keys() == port.state_dict().keys()
    port.load_state_dict(sd, strict=True)


def test_advit_reference_file_loads_without_its_mlp_head():
    """A reference ADVIT state_dict carries each ViT's `mlp_head`, which
    the CLS-latent reading leaves dead: the port's importer skips it (as
    JAX's import does), the strict loader takes the rest, and every other
    key is still required."""
    from transmf_ad_tpu_torch.train.trainer import _load_model
    from transmf_ad_tpu_torch.utils.torch_import import \
        import_torch_checkpoint

    port = build_model("advit", input_shape=(32, 32, 79))
    sd = {k: torch.randn_like(t) for k, t in port.state_dict().items()}
    sd["vit_mri.mlp_head.0.weight"] = torch.zeros(2, 192)
    sd["vit_pet.mlp_head.0.bias"] = torch.zeros(2)
    _load_model(port, import_torch_checkpoint(sd, "advit", port))
    assert torch.equal(port.vit_pet.pos_embedding, sd["vit_pet.pos_embedding"])
    with pytest.raises(RuntimeError, match="mlp_head"):
        _load_model(port, sd)  # the strict loader takes no dead keys
    del sd["vit_mri.cls_token"]
    with pytest.raises(KeyError, match="cls_token"):
        import_torch_checkpoint(sd, "advit", port)
