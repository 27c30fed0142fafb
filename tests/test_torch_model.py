"""Port modules and the ModelAd slice against the JAX package, float32 CPU.

See tests/_torch_parity.py for how weights, inputs and tolerances are made.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import close, model_ad, volumes
from transmf_ad_tpu import nn as jnn
from transmf_ad_tpu_torch import nn as tnn
from transmf_ad_tpu_torch.nn.dropout import Dropout
from transmf_ad_tpu_torch.utils.weights import cross_transformer_state_dict

model_ad = pytest.fixture(scope="module")(model_ad)


def test_snet_eval(model_ad):
    """One encoder of the model, with its randomised BN statistics."""
    _, v, port = model_ad
    x = volumes(1)[0][..., None]
    ref = jax.jit(jnn.SNet(dim=16, use_pallas=True).apply)(
        {c: v[c]["mri_cnn"] for c in ("params", "batch_stats")},
        jnp.asarray(x))
    with torch.inference_mode():
        out = port.mri_cnn(torch.from_numpy(x))
    assert out.shape == ref.shape == (2, 2, 2, 2, 16)
    close(out, ref)


def test_cross_transformer_mod_avg():
    rng = np.random.default_rng(2)
    mri, pet = (rng.standard_normal((2, 24, 16)).astype(np.float32)
                for _ in range(2))
    kw = dict(dim=16, depth=2, heads=2, dim_head=8, mlp_dim=32)
    v = jax.jit(jnn.CrossTransformerModAvg(**kw, use_pallas=False).init)(
        jax.random.key(1), jnp.asarray(mri), jnp.asarray(pet))
    ref = jax.jit(jnn.CrossTransformerModAvg(**kw, use_pallas=True).apply)(
        v, jnp.asarray(mri), jnp.asarray(pet))
    mod = tnn.CrossTransformerModAvg(**kw).eval()
    mod.load_state_dict(cross_transformer_state_dict(v["params"]),
                        strict=True)
    out = mod(torch.from_numpy(mri), torch.from_numpy(pet))
    assert out.shape == ref.shape == (2, 64)
    close(out, ref)


def test_model_ad_eval(model_ad):
    """The slice as a whole: logits, d_mri and d_pet."""
    jmodel, v, port = model_ad
    mri, pet = volumes(5)
    ref = jax.jit(jmodel.apply)(v, jnp.asarray(mri[..., None]),
                                jnp.asarray(pet[..., None]))
    with torch.inference_mode():
        out = port(torch.from_numpy(mri[..., None]),
                   torch.from_numpy(pet[..., None]))
    for o, r in zip(out, ref):
        assert o.shape == r.shape == (2, 2)
        close(o, r)


def _port_hparams(m):
    """The hyperparameters a port model was built with, read off its
    modules: dim, depth, heads, dim_head, mlp_dim, dropout, head_dropout
    and, where it has one, grl_alpha."""
    layers = m.fuse_transformer.layers
    attn, ff = (sub.fn for sub in layers[0][0].layers[0])
    drops = [d.p for d in m.fc_cls if isinstance(d, Dropout)]
    out = dict(dim=attn.to_q.in_features, depth=len(layers),
               heads=attn.heads, dim_head=attn.dim_head,
               mlp_dim=ff.net[0].out_features, dropout=attn.to_out[1].p,
               head_dropout=drops[0])
    if hasattr(m, "grl_alpha"):
        out["grl_alpha"] = m.grl_alpha
    return out


@pytest.mark.parametrize("kw", [
    {}, {"grl_alpha": 3.0}, {"use_pallas": True}, {"remat": True},
    {"dim_head": 16},
    {"dim": 64, "heads": 2, "depth": 1, "dropout": 0.1, "grl_alpha": 1.5,
     "head_dropout": 0.25, "use_pallas": False, "remat": True},
], ids=["defaults", "grl_alpha", "use_pallas", "remat", "dim_head", "mixed"])
@pytest.mark.parametrize("name", ["ad", "transformer", "transformer_res"])
def test_build_model_follows_jax_rule(name, kw):
    """The port's build_model builds wherever the JAX package's does, from
    the same keywords, dropping those the class does not take, and the two
    models carry the same hyperparameters."""
    from transmf_ad_tpu.models import build_model as j_build_model
    from transmf_ad_tpu_torch.models import build_model

    jm, pm = j_build_model(name, **kw), build_model(name, **kw)
    want = {k: getattr(jm, k) for k in _port_hparams(pm)}
    assert _port_hparams(pm) == want
    if name != "ad":
        assert not hasattr(pm, "grl_alpha") and not hasattr(jm, "grl_alpha")


def test_build_model_unknown_name_raises():
    from transmf_ad_tpu.models import build_model as j_build_model
    from transmf_ad_tpu_torch.models import build_model

    for fn in (j_build_model, build_model):
        with pytest.raises(ValueError, match="unknown"):
            fn("no_such_model", grl_alpha=2.0)
