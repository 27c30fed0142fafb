"""The full-resolution slice, port against JAX, float32 CPU.

A small ModelAd whose two stage-2 convs take the band route and whose other
body convs stay plain convolutions, as at 182x218x182: the threshold is put
between the stage-2 and the stage-3 volume on both sides (the port's
`band_min_voxels`, the JAX package's `TRANSMF_BAND_CONV_MIN_VOX`;
`tests/_torch_parity.py::band_route`). Eval outputs, then one SGD step (lr 1,
so each update is minus its gradient): the losses, every parameter update and
every running statistic, at the batch size and volume of
tests/test_torch_train.py, for each numpy seed in SEEDS.

A one-step update is ill-conditioned in float32 (see there): a max-pool
winner or a LeakyReLU side that flips moves a weight gradient by a finite
amount. So the conditioning is measured, not avoided by the choice of a
seed: the JAX step is repeated on DRAWS copies of the batch whose volumes are
multiplied by (1 + EPS * N(0, 1)), a few float32 ulps, and each tensor's
tolerance is 1e-4 of max(1, its largest magnitude) plus SLACK times the
largest distance of a perturbed JAX step from the unperturbed one. A wrong
gradient or rounding step misses by O(1) of the tensor's magnitude.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import band_route, model_ad
from tests._torch_parity import unit_scale_close as _scale_close
from transmf_ad_tpu.train import build_optimizer as j_build_optimizer
from transmf_ad_tpu.train import create_state as j_create_state
from transmf_ad_tpu.train import make_train_step as j_make_train_step
from transmf_ad_tpu_torch.train import create_state, make_train_step
from transmf_ad_tpu_torch.utils.weights import state_dict_from_jax

WIDTHS = dict(dim=24, depth=1, heads=2, dim_head=12, mlp_dim=40)
BATCH, SHAPE = 4, (33, 19, 17)
SEEDS = tuple(range(2, 10))  # 2 is tests/test_torch_train.py's seed
DRAWS, EPS, SLACK = 4, 1e-6, 3.0
# stage 2 sees 16 x 9 x 8 = 1,152 voxels, stage 3 sees 8 x 4 x 4 = 128
MIN_VOXELS = 1000
SGD = dict(name="SGD", lr=1.0, milestones=())


@pytest.fixture(scope="module")
def band_calls():
    with band_route(MIN_VOXELS) as calls:
        yield calls


@pytest.fixture(scope="module")
def ad(band_calls):
    """(JAX ModelAd on the band route, its variables, the port's ModelAd
    with `band_min_voxels=MIN_VOXELS` and the same weights)."""
    return model_ad(head_dropout=0.0, port_kw=dict(band_min_voxels=MIN_VOXELS),
                    **WIDTHS)


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"MRI": rng.standard_normal((BATCH, *SHAPE)).astype(np.float32),
            "PET": rng.standard_normal((BATCH, *SHAPE)).astype(np.float32),
            "label": (np.arange(BATCH) % 2).astype(np.int32)}


def _perturbed(batch, seed):
    rng = np.random.default_rng(seed)
    return {k: v if k == "label" else
            (v * (1.0 + EPS * rng.standard_normal(v.shape))).astype(np.float32)
            for k, v in batch.items()}


def test_model_ad_eval_band_route(ad, band_calls):
    jmodel, v, port = ad
    batch = _batch(SEEDS[0])
    n = len(band_calls)
    ref = jax.jit(jmodel.apply)(v, jnp.asarray(batch["MRI"][..., None]),
                                jnp.asarray(batch["PET"][..., None]))
    assert len(band_calls) == n + 4  # 2 encoders x 2 convs
    with torch.inference_mode():
        out = port(torch.from_numpy(batch["MRI"][..., None]),
                   torch.from_numpy(batch["PET"][..., None]))
    for name, o, r in zip(("logits", "d_mri", "d_pet"), out, ref):
        _scale_close(o.numpy(), r, name)


AUX = ("loss", "ce_loss", "ad_loss", "logits", "d_mri", "d_pet")


def _tensors(aux, before, after):
    """name -> numpy array for the step's outputs, every parameter update
    and every running statistic (state dicts with the port's names)."""
    out = {k: np.asarray(aux[k]) for k in AUX}
    for k, t in after.items():
        if "running" in k:
            out[k] = t.numpy()
        else:
            out[k + " update"] = (t - before[k]).numpy()
    return out


@pytest.fixture(scope="module")
def j_step(ad, band_calls):
    """batch -> tensors of one JAX SGD step from the shared weights; one
    trace serves every call."""
    jmodel, v, _ = ad
    x = jnp.zeros((1, 16, 16, 16, 1), jnp.float32)
    state = j_create_state(jmodel, j_build_optimizer(**SGD)[0], [x, x],
                           jax.random.key(0)).replace(
        params=v["params"], batch_stats=v["batch_stats"])
    step = j_make_train_step(donate=False)
    before = state_dict_from_jax(v)

    def run(batch):
        new, aux = step(state, batch, jax.random.key(1))
        return _tensors(aux, before, state_dict_from_jax(
            {"params": new.params, "batch_stats": new.batch_stats}))
    n = len(band_calls)
    run(_batch(SEEDS[0]))
    assert len(band_calls) == n + 8  # forward and dx
    return run


@pytest.fixture(scope="module", params=SEEDS)
def sgd_step(request, ad, j_step):
    """(the JAX step's tensors, each one's spread over the perturbed JAX
    steps, the port's tensors) for one SGD step (lr 1, so each update is
    minus the gradient) from the same weights on the same batch."""
    batch = _batch(request.param)
    ref = j_step(batch)
    draws = [j_step(_perturbed(batch, d)) for d in range(DRAWS)]
    spread = {k: max(float(np.abs(d[k] - r).max()) for d in draws)
              for k, r in ref.items()}
    port = copy.deepcopy(ad[2])
    before = {k: t.clone() for k, t in port.state_dict().items()}
    aux = make_train_step()(create_state(port, "cpu", **SGD), batch)
    got = _tensors({k: aux[k].numpy() for k in AUX}, before,
                   port.state_dict())
    return ref, spread, got


def _close(sgd_step, names):
    ref, spread, got = sgd_step
    for k in names:
        tol = (1e-4 * max(1.0, float(np.abs(ref[k]).max()))
               + SLACK * spread[k])
        err = float(np.abs(got[k] - ref[k]).max())
        assert err <= tol, (  # a NaN fails too
            f"{k}: {err} > {tol} (of which {SLACK} x {spread[k]} from the "
            "perturbed steps)")


def test_sgd_step_losses_band_route(sgd_step):
    _close(sgd_step, AUX)


def test_sgd_step_parameter_updates_band_route(sgd_step):
    ref, _, got = sgd_step
    params = [k for k in got if k.endswith(" update")]
    assert params and set(params) == {k for k in ref if k.endswith(" update")}
    _close(sgd_step, params)


def test_sgd_step_running_statistics_band_route(sgd_step, ad):
    ref, _, got = sgd_step
    stats = [k for k in got if "running" in k]
    assert stats and set(stats) == {k for k in ref if "running" in k}
    before = ad[2].state_dict()
    for k in stats:
        assert not np.array_equal(got[k], before[k].numpy()), k
    _close(sgd_step, stats)
