"""The port's `ModelCNN` and `ModelCNNAd` against the JAX package's, float32
CPU, with the same weights (`state_dict_from_jax`, randomised BatchNorm
statistics).

The eval forward runs the JAX model with its Pallas kernels in interpret
mode (`tests/_torch_parity.py`): logits (and d_mri, d_pet) within 1e-4.
One SGD step (lr 1, no momentum: each update is minus the gradient) of
ModelCNNAd through both packages' `make_train_step`, the JAX step on its
plain path (use_pallas=False; the port's kernels are held to the Pallas
ones by the op tests). A one-step update is ill-conditioned in float32
(ROADMAP.md Queue 3: a max-pool winner or a LeakyReLU side that flips moves
a weight gradient by a finite amount), so the conditioning is measured as
`tests/test_torch_fullres_step.py` measures it: the JAX step is repeated on
DRAWS copies of the batch whose volumes are multiplied by
(1 + EPS * N(0, 1)), and each tensor's tolerance is 1e-4 of max(1, its
largest magnitude) plus SLACK times the largest distance of a perturbed
JAX step from the unperturbed one. That covers the losses, every parameter
update and every running statistic.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from tests._torch_parity import close, model, volumes
from transmf_ad_tpu.models import build_model as j_build_model
from transmf_ad_tpu.train import build_optimizer as j_build_optimizer
from transmf_ad_tpu.train import create_state as j_create_state
from transmf_ad_tpu.train import make_train_step as j_make_train_step
from transmf_ad_tpu.utils.torch_import import map_state_dict
from transmf_ad_tpu_torch.models import ADVERSARIAL, build_model
from transmf_ad_tpu_torch.train import create_state, make_train_step

DIM = 16
SGD = dict(name="SGD", lr=1.0, milestones=())
DRAWS, EPS, SLACK = 4, 1e-6, 3.0


@pytest.fixture(scope="module", params=["cnn", "cnn_ad"])
def cnn(request):
    name = request.param
    jmodel, v, port = model(name, dim=DIM)
    return name, jmodel, v, port


def test_build_model_keywords(cnn):
    """The CNN models take dim alone, as JAX's build_model gives them."""
    name = cnn[0]
    port = build_model(name, dim=DIM, depth=5, heads=7, dropout=0.3,
                       dim_head=3)
    assert port.mri_cnn.conv1["0"].out_channels == DIM // 4
    assert (name in ADVERSARIAL) == (name == "cnn_ad")
    jm = j_build_model(name, dim=DIM, depth=5, heads=7, dropout=0.3)
    assert jm.dim == DIM


def test_forward(cnn):
    name, jmodel, v, port = cnn
    mri, pet = volumes(1)
    want = jax.jit(lambda v, a, b: jmodel.apply(v, a, b))(
        v, jnp.asarray(mri)[..., None], jnp.asarray(pet)[..., None])
    with torch.inference_mode():
        got = port.eval()(torch.from_numpy(mri)[..., None],
                          torch.from_numpy(pet)[..., None])
    if name == "cnn":
        got, want = (got,), (want,)
    assert len(got) == len(want) == (3 if name == "cnn_ad" else 1)
    for g, w in zip(got, want):
        assert g.shape == (2, 2)
        close(g, w)


def _batch(seed, b=4, shape=(33, 19, 17)):
    rng = np.random.default_rng(seed)
    return {"MRI": rng.standard_normal((b, *shape)).astype(np.float32),
            "PET": rng.standard_normal((b, *shape)).astype(np.float32),
            "label": (np.arange(b) % 2).astype(np.int32)}


def _perturbed(batch, seed):
    rng = np.random.default_rng(seed)
    return {k: v if k == "label" else
            (v * (1.0 + EPS * rng.standard_normal(v.shape))).astype(np.float32)
            for k, v in batch.items()}


def _flat(aux, params, stats):
    out = {k: np.asarray(aux[k]) for k in ("loss", "ce_loss", "ad_loss",
                                           "logits")}
    for col, tree in (("params", params), ("batch_stats", stats)):
        for k, v in traverse_util.flatten_dict(tree).items():
            out[(col, *k)] = np.asarray(v)
    return out


def test_sgd_step(cnn):
    name, _, v, port = cnn
    adversarial = name in ADVERSARIAL
    jmodel = j_build_model(name, use_pallas=False, dim=DIM)
    x = jnp.zeros((1, 16, 16, 16, 1), jnp.float32)
    state = j_create_state(jmodel, j_build_optimizer(**SGD)[0], [x, x],
                           jax.random.key(0)).replace(
        params=v["params"], batch_stats=v["batch_stats"])
    j_step = j_make_train_step(adversarial=adversarial, donate=False)

    def run(batch):
        new, aux = j_step(state, batch, jax.random.key(1))
        return _flat(aux, new.params, new.batch_stats)

    batch = _batch(2)
    ref = run(batch)
    draws = [run(_perturbed(batch, d)) for d in range(DRAWS)]
    port = copy.deepcopy(port)
    port_aux = make_train_step(adversarial=adversarial)(
        create_state(port, "cpu", **SGD), batch)
    got = _flat({k: port_aux[k].numpy() for k in ("loss", "ce_loss",
                                                  "ad_loss", "logits")},
                *map_state_dict({k: t.detach() for k, t in
                                 port.state_dict().items()}, name))
    assert got.keys() == ref.keys()
    for k, r in ref.items():
        spread = max(float(np.abs(d[k] - r).max()) for d in draws)
        tol = 1e-4 * max(1.0, float(np.abs(r).max())) + SLACK * spread
        err = float(np.abs(got[k] - r).max())
        assert err <= tol, (  # a NaN fails too
            f"{k}: {err} > {tol} (of which {SLACK} x {spread} from the "
            "perturbed steps)")
