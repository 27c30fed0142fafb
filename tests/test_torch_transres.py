"""The joint-context slice, port against JAX, float32 CPU: `CrossTransformer`,
`ModelTransformer` and `ModelTransformerRes`.

Each eval forward runs twice: at the shipped gate (2,048 keys, so these
small token counts take the single-pass attention on both sides), and with
the gate lowered to FLASH_GATE keys on both sides
(`tests/_torch_parity.py::flash_route`), so that the JAX side runs its three
flash Pallas kernels in interpret mode and the port the plain versions of
K10-K12, as `ModelTransformerRes` does at 182x218x182 with its 3,146 keys.
Then one SGD step (lr 1, so each update is minus its gradient) of
`ModelTransformerRes` on the flash route: the loss, the logits, every
parameter update and every running statistic.

Tolerances: 1e-4 at O(1) outputs (tests/_torch_parity.py). The step's
tensors: 1e-4 of max(1, the tensor's largest magnitude) plus SLACK times the
spread of DRAWS JAX steps on inputs perturbed by EPS, since a one-step update
is ill-conditioned in float32 (tests/test_torch_fullres_step.py says why).
"""

import contextlib
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import close, flash_route, model
from tests._torch_parity import unit_scale_close as _scale_close
from transmf_ad_tpu import nn as jnn
from transmf_ad_tpu.train import build_optimizer as j_build_optimizer
from transmf_ad_tpu.train import create_state as j_create_state
from transmf_ad_tpu.train import make_train_step as j_make_train_step
from transmf_ad_tpu_torch import nn as tnn
from transmf_ad_tpu_torch.train import create_state, make_train_step
from transmf_ad_tpu_torch.utils.weights import (cross_transformer_state_dict,
                                                state_dict_from_jax)

FLASH_GATE = 8
ROUTES = [None, FLASH_GATE]
ROUTE_IDS = ["single pass", "flash route"]
# 2 x 2 x 3 = 12 tokens a modality: 24 keys in the joint context. The inputs
# are fixed by seed at a batch and volume where no LeakyReLU sign or max-pool
# winner separates the two sides: one such flip in a small late feature map
# moves the conv gradients below it by percents, and DRAWS perturbed steps do
# not see an event that rare (at batch 4, (51, 53, 49) each encoder has one;
# ROADMAP.md, Queue 3).
BATCH, SHAPE = 3, (33, 35, 49)
WIDTHS = dict(dim=16, depth=2, heads=2, dim_head=8, mlp_dim=32)
SEEDS = (2, 3)
DRAWS, EPS, SLACK = 4, 1e-6, 3.0
SGD = dict(name="SGD", lr=1.0, milestones=())


@contextlib.contextmanager
def _route(min_keys, forwards):
    """The flash route at `min_keys` (None: the shipped gate), checked on
    leaving: `forwards` flash forwards on each side, or none at all."""
    with flash_route(2048 if min_keys is None else min_keys) as calls:
        yield calls
    want = 0 if min_keys is None else forwards
    assert calls.count("jax") == calls.count("port") == want, calls


@pytest.mark.parametrize("min_keys", ROUTES, ids=ROUTE_IDS)
@pytest.mark.parametrize("share", [False, True], ids=["pairs", "shared"])
def test_cross_transformer(share, min_keys):
    """Both streams' outputs; the PET stream's context holds the updated MRI
    tokens. share=True: one encoder per depth serves both streams."""
    rng = np.random.default_rng(2)
    mri, pet = (rng.standard_normal((2, 24, 16)).astype(np.float32)
                for _ in range(2))
    kw = dict(WIDTHS, share=share)
    v = jax.jit(jnn.CrossTransformer(**kw, use_pallas=False).init)(
        jax.random.key(1), jnp.asarray(mri), jnp.asarray(pet))
    assert len(v["params"]) == (2 if share else 4)
    mod = tnn.CrossTransformer(**kw).eval()
    mod.load_state_dict(cross_transformer_state_dict(v["params"],
                                                     share=share),
                        strict=True)
    jmod = jnn.CrossTransformer(**kw, use_pallas=True)
    with _route(min_keys, 4):  # depth 2 x 2 streams, 48 keys each
        ref = jax.jit(lambda *a: jmod.apply(*a))(v, jnp.asarray(mri),
                                                 jnp.asarray(pet))
        out = mod(torch.from_numpy(mri), torch.from_numpy(pet))
    for o, r in zip(out, ref, strict=True):
        assert o.shape == r.shape == (2, 24, 16)
        close(o, r)
    if share:
        assert mod.layers[0][0] is mod.layers[0][1]
        assert len(list(mod.parameters())) == 2 * 14  # 14 tensors an encoder


@pytest.fixture(scope="module", params=["transformer", "transformer_res"])
def zoo(request):
    """(name, JAX model with Pallas on, its variables, the port's model with
    the same weights), head dropout off."""
    return (request.param, *model(request.param, head_dropout=0.0, **WIDTHS))


def _volumes(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((BATCH, *SHAPE)).astype(np.float32)
            for _ in range(2)]


@pytest.mark.parametrize("min_keys", ROUTES, ids=ROUTE_IDS)
def test_model_eval(zoo, min_keys):
    """The eval forward of each model: plain logits, no triple."""
    name, jmodel, v, port = zoo
    mri, pet = (x[:2] for x in _volumes(5))
    with _route(min_keys, 4):
        ref = jax.jit(lambda *a: jmodel.apply(*a))(
            v, jnp.asarray(mri[..., None]), jnp.asarray(pet[..., None]))
        with torch.inference_mode():
            out = port(torch.from_numpy(mri[..., None]),
                       torch.from_numpy(pet[..., None]))
    assert isinstance(out, torch.Tensor) and out.shape == ref.shape == (2, 2)
    close(out, ref)


def test_transformer_res_has_no_head_statistics(zoo):
    name, _, v, port = zoo
    head_stats = [k for k in port.state_dict()
                  if k.startswith("fc_cls") and "running" in k]
    if name == "transformer_res":
        assert not head_stats and "fc_cls" not in v["batch_stats"]
        assert sorted(k for k in port.state_dict() if k.startswith("fc_cls")) \
            == [f"fc_cls.{i}.{p}" for i in (0, 3, 6)
                for p in ("bias", "weight")]
    else:
        assert len(head_stats) == 4


AUX = ("loss", "ce_loss", "ad_loss", "logits")


def _batch(seed):
    mri, pet = _volumes(seed)
    return {"MRI": mri, "PET": pet,
            "label": (np.arange(BATCH) % 2).astype(np.int32)}


def _perturbed(batch, seed):
    rng = np.random.default_rng(seed)
    return {k: v if k == "label" else
            (v * (1.0 + EPS * rng.standard_normal(v.shape))).astype(np.float32)
            for k, v in batch.items()}


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
def res():
    return model("transformer_res", head_dropout=0.0, **WIDTHS)


@pytest.fixture(scope="module")
def flash_calls():
    with flash_route(FLASH_GATE) as calls:
        yield calls


@pytest.fixture(scope="module")
def j_step(res, flash_calls):
    """batch -> tensors of one JAX SGD step (adversarial=False) from the
    shared weights, traced once on the flash route."""
    jmodel, v, _ = res
    x = jnp.zeros((1, 16, 16, 16, 1), jnp.float32)
    state = j_create_state(jmodel, j_build_optimizer(**SGD)[0], [x, x],
                           jax.random.key(0)).replace(
        params=v["params"], batch_stats=v["batch_stats"])
    step = j_make_train_step(adversarial=False, donate=False)
    before = state_dict_from_jax(v, "transformer_res")

    def run(batch):
        new, aux = step(state, batch, jax.random.key(1))
        return _tensors(aux, before, state_dict_from_jax(
            {"params": new.params, "batch_stats": new.batch_stats},
            "transformer_res"))
    run(_batch(SEEDS[0]))
    # the forward rule of each of the 4 attention calls, once per trace
    assert flash_calls.count("jax") >= 4 and "port" not in flash_calls
    return run


@pytest.fixture(scope="module", params=SEEDS)
def sgd_step(request, res, j_step, flash_calls):
    """(the JAX step's tensors, each one's spread over the perturbed JAX
    steps, the port's tensors) for one SGD step from the same weights on
    the same batch, both on the flash route."""
    batch = _batch(request.param)
    ref = j_step(batch)
    draws = [j_step(_perturbed(batch, d)) for d in range(DRAWS)]
    spread = {k: max(float(np.abs(d[k] - r).max()) for d in draws)
              for k, r in ref.items()}
    port = copy.deepcopy(res[2])
    before = {k: t.clone() for k, t in port.state_dict().items()}
    n = flash_calls.count("port")
    aux = make_train_step(adversarial=False)(
        create_state(port, "cpu", **SGD), batch)
    assert flash_calls.count("port") == n + 4  # its backward: the lse formula
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


def test_sgd_step_losses_flash_route(sgd_step):
    ref, _, got = sgd_step
    assert float(got["ad_loss"]) == float(ref["ad_loss"]) == 0.0
    _close(sgd_step, AUX)


def test_sgd_step_parameter_updates_flash_route(sgd_step):
    ref, _, got = sgd_step
    params = [k for k in got if k.endswith(" update")]
    assert params and set(params) == {k for k in ref if k.endswith(" update")}
    # every attention projection moved: the flash backward reached q, k and v
    for k in params:
        if "to_q" in k or "to_kv" in k:
            assert np.abs(got[k]).max() > 0, k
    _close(sgd_step, params)


def test_sgd_step_running_statistics_flash_route(sgd_step, res):
    ref, _, got = sgd_step
    stats = [k for k in got if "running" in k]
    assert stats and set(stats) == {k for k in ref if "running" in k}
    before = res[2].state_dict()
    for k in stats:
        assert not np.array_equal(got[k], before[k].numpy()), k
    _close(sgd_step, stats)
