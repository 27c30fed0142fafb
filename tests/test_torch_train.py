"""The port's train step against the JAX package's, float32 CPU.

One JAX ModelAd at SMALL widths is shared by the module's tests. One SGD
step (lr 1, no momentum, so each parameter update is minus its gradient)
from the same weights through `make_train_step` on both sides,
the JAX one with its Pallas kernels in interpret mode. Batch 4: with 2
samples every BatchNorm1d gradient is O(eps / var), a difference of
rounding. Tolerance: 1e-4 of max(1, the tensor's largest magnitude). Both
sides compute in float32 and differ in the order of float32 sums; XLA's CPU
reductions of the BatchNorm moments are the less accurate ones (a variance
off by ~1e-4 relative at 4e4 samples, where torch's is off by ~1e-6), and
the JAX package's own Pallas and XLA paths differ from each other by about
this tolerance. Near a LeakyReLU kink or a max-pool tie such a difference can
flip which side of it a value lies on, and the gradient there moves by O(1):
the inputs are fixed by a numpy seed. Three Adam steps compare the losses.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import model_ad, randomize_bn
from transmf_ad_tpu.nn import batchnorm as j_bn
from transmf_ad_tpu.nn.losses import cross_entropy as j_cross_entropy
from transmf_ad_tpu.train import build_optimizer as j_build_optimizer
from transmf_ad_tpu.train import create_state as j_create_state
from transmf_ad_tpu.train import make_train_step as j_make_train_step
from transmf_ad_tpu_torch.nn import BatchNormMasked, ManualBN, dropout
from transmf_ad_tpu_torch.nn.losses import cross_entropy
from transmf_ad_tpu_torch.train import create_state, make_train_step
from transmf_ad_tpu_torch.utils.weights import state_dict_from_jax

BATCH, SHAPE, SEED = 4, (33, 19, 17), 2
SGD = dict(name="SGD", lr=1.0, milestones=())


def _batch(seed, b=BATCH, shape=SHAPE):
    rng = np.random.default_rng(seed)
    return {"MRI": rng.standard_normal((b, *shape)).astype(np.float32),
            "PET": rng.standard_normal((b, *shape)).astype(np.float32),
            "label": (np.arange(b) % 2).astype(np.int32)}


def _scale_close(port, ref, what):
    port, ref = np.asarray(port), np.asarray(ref)
    tol = 1e-4 * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(port - ref).max())
    assert err <= tol, f"{what}: {err} > {tol}"


@pytest.fixture(scope="module")
def ad():
    """(JAX ModelAd, its variables, a port ModelAd with the same weights);
    tests train deep copies of the port model."""
    return model_ad(head_dropout=0.0)


def _j_state(jmodel, v, tx):
    x = jnp.zeros((1, 16, 16, 16, 1), jnp.float32)
    return j_create_state(jmodel, tx, [x, x], jax.random.key(0)).replace(
        params=v["params"], batch_stats=v["batch_stats"])


@pytest.fixture(scope="module")
def sgd_step(ad):
    """(JAX aux, JAX variables before and after, port aux, port state_dict
    before and after) for one SGD step on the same batch."""
    jmodel, v, port = ad
    port = copy.deepcopy(port)
    state = _j_state(jmodel, v, j_build_optimizer(**SGD)[0])
    batch = _batch(SEED)
    new, aux = j_make_train_step(donate=False)(state, batch,
                                               jax.random.key(1))
    after = {"params": new.params, "batch_stats": new.batch_stats}
    before = {k: t.clone() for k, t in port.state_dict().items()}
    port_aux = make_train_step()(create_state(port, "cpu", **SGD), batch)
    return aux, v, after, port_aux, before, port.state_dict()


def test_sgd_step_losses(sgd_step):
    aux, _, _, port_aux, _, _ = sgd_step
    for k in ("loss", "ce_loss", "ad_loss", "logits", "d_mri", "d_pet"):
        np.testing.assert_allclose(port_aux[k].numpy(), np.asarray(aux[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    np.testing.assert_array_equal(port_aux["label"].numpy(),
                                  np.asarray(aux["label"]))
    np.testing.assert_array_equal(port_aux["mask"].numpy(),
                                  np.asarray(aux["mask"]))


def test_sgd_step_parameter_updates(sgd_step):
    _, v, after, _, before, port_after = sgd_step
    ref_before, ref_after = state_dict_from_jax(v), state_dict_from_jax(after)
    params = [k for k in port_after if "running" not in k]
    assert set(params) == {k for k in ref_after if "running" not in k}
    for k in params:
        _scale_close(port_after[k] - before[k], ref_after[k] - ref_before[k],
                     k)


def test_sgd_step_running_statistics(sgd_step):
    _, v, after, _, before, port_after = sgd_step
    ref_after = state_dict_from_jax(after)
    stats = [k for k in port_after if "running" in k]
    assert stats
    for k in stats:
        assert not torch.equal(port_after[k], before[k]), k
        _scale_close(port_after[k], ref_after[k], k)


def test_adam_three_steps(ad):
    """Three Adam steps from the same weights on three batches: the losses
    agree, so the moments, bias correction and schedule step alike."""
    jmodel, v, port = ad
    kw = dict(lr=1e-3, steps_per_epoch=1, milestones=(1,), gamma=0.5)
    state = _j_state(jmodel, v, j_build_optimizer("Adam", **kw)[0])
    j_step = j_make_train_step(donate=False)
    port_state = create_state(copy.deepcopy(port), "cpu", name="Adam", **kw)
    step = make_train_step()
    rng = np.random.default_rng(11)
    for i in range(3):
        batch = {"MRI": rng.standard_normal((4, 33, 19, 17), np.float32),
                 "PET": rng.standard_normal((4, 33, 19, 17), np.float32),
                 "label": np.array([0, 1, 1, 0], np.int32)}
        state, aux = j_step(state, batch, jax.random.key(i))
        port_aux = step(port_state, batch)
        for k in ("loss", "ce_loss", "ad_loss"):
            np.testing.assert_allclose(port_aux[k].numpy(),
                                       np.asarray(aux[k]), rtol=1e-4,
                                       atol=1e-4, err_msg=f"step {i} {k}")
    assert port_state.step == 3
    assert port_state.optimizer.param_groups[0]["lr"] == pytest.approx(5e-4)


def test_masked_batch_matches_short_batch(ad):
    """mask_bn=True: a duplicate-padded batch trains like its real samples
    alone (tests/test_train.py::TestMaskedBN for the JAX package)."""
    short = _batch(3, b=3, shape=(19, 21, 17))
    padded = {k: np.concatenate([v, v[-1:]]) for k, v in short.items()}
    padded["mask"] = np.array([1.0, 1.0, 1.0, 0.0], np.float32)
    models = [copy.deepcopy(ad[2]) for _ in range(2)]
    sgd = dict(name="SGD", lr=1e-2, milestones=())
    aux_ref = make_train_step()(create_state(models[0], "cpu", **sgd), short)
    aux_pad = make_train_step(mask_bn=True)(
        create_state(models[1], "cpu", **sgd), padded)
    # float32 reduction order: per-sample then weighted sums of 4 samples
    # against plain sums of 3
    for k in ("loss", "ce_loss", "ad_loss"):
        np.testing.assert_allclose(aux_pad[k].numpy(), aux_ref[k].numpy(),
                                   rtol=1e-5, err_msg=k)
    ref, pad = (m.state_dict() for m in models)
    for k in ref:
        np.testing.assert_allclose(pad[k].numpy(), ref[k].numpy(), rtol=1e-3,
                                   atol=1e-5, err_msg=k)


def _bn_case(rng, shape, kind):
    y = (1.0 + rng.standard_normal(shape)).astype(np.float32)
    c = shape[-1]
    stats = mask = None
    if kind == "stats":
        yf = y.reshape(-1, c).astype(np.float64)
        stats = (yf.sum(0).astype(np.float32),
                 (yf * yf).sum(0).astype(np.float32), yf.shape[0])
    if kind == "mask":
        mask = np.array([1.0, 0.0, 1.0], np.float32)
    return y, stats, mask


@pytest.mark.parametrize("kind", ["moments", "stats", "mask"])
def test_manual_bn_train(rng, kind):
    """The affine and the running updates in training, from the batch
    moments, producer sums, or mask-weighted moments; conv bias folded."""
    y, stats, mask = _bn_case(rng, (3, 4, 5, 6, 8), kind)
    bias = rng.standard_normal(8).astype(np.float32)
    vs = randomize_bn({"params": {"BatchNorm_0": {
        "scale": jnp.ones(8), "bias": jnp.zeros(8)}},
        "batch_stats": {"BatchNorm_0": {"mean": jnp.zeros(8),
                                        "var": jnp.ones(8)}}}, seed=1)
    jstats = None if stats is None else tuple(
        jnp.asarray(s) if i < 2 else s for i, s in enumerate(stats))
    (scale, shift), upd = j_bn.ManualBN().apply(
        {"params": vs["params"]["BatchNorm_0"],
         "batch_stats": vs["batch_stats"]["BatchNorm_0"]},
        jnp.asarray(y), jnp.asarray(bias), True, jstats,
        None if mask is None else jnp.asarray(mask),
        mutable=["batch_stats"])
    bn = ManualBN(8)
    bn.load_state_dict({
        "weight": torch.from_numpy(np.asarray(vs["params"]["BatchNorm_0"]
                                              ["scale"])),
        "bias": torch.from_numpy(np.asarray(vs["params"]["BatchNorm_0"]
                                            ["bias"])),
        "running_mean": torch.from_numpy(np.asarray(
            vs["batch_stats"]["BatchNorm_0"]["mean"])),
        "running_var": torch.from_numpy(np.asarray(
            vs["batch_stats"]["BatchNorm_0"]["var"]))})
    tstats = None if stats is None else (torch.from_numpy(stats[0]),
                                         torch.from_numpy(stats[1]),
                                         stats[2])
    got = bn(torch.from_numpy(y), torch.from_numpy(bias), True, tstats,
             None if mask is None else torch.from_numpy(mask))
    for a, r in zip(got, (scale, shift)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(r),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_batchnorm_masked_train(rng, masked):
    x = rng.standard_normal((5, 12)).astype(np.float32)
    mask = np.array([1, 1, 0, 1, 0], np.float32) if masked else None
    g = rng.standard_normal((5, 12)).astype(np.float32)
    mod = j_bn.BatchNormMasked()
    v = mod.init(jax.random.key(0), jnp.asarray(x))
    v = randomize_bn({"params": {"BatchNorm_0": v["params"]},
                      "batch_stats": {"BatchNorm_0": v["batch_stats"]}},
                     seed=2)
    params = v["params"]["BatchNorm_0"]
    stats = v["batch_stats"]["BatchNorm_0"]
    jm = None if mask is None else jnp.asarray(mask)

    def f(xx):
        out, upd = mod.apply({"params": params, "batch_stats": stats}, xx,
                             True, jm, mutable=["batch_stats"])
        return out, upd

    out, pull, upd = jax.vjp(f, jnp.asarray(x), has_aux=True)
    (dx,) = pull(jnp.asarray(g))
    bn = BatchNormMasked(12)
    bn.load_state_dict({
        "weight": torch.from_numpy(np.asarray(params["scale"])),
        "bias": torch.from_numpy(np.asarray(params["bias"])),
        "running_mean": torch.from_numpy(np.asarray(stats["mean"])),
        "running_var": torch.from_numpy(np.asarray(stats["var"]))})
    xt = torch.from_numpy(x).requires_grad_()
    got = bn(xt, True, None if mask is None else torch.from_numpy(mask))
    got.backward(torch.from_numpy(g))
    for a, r in ((got.detach(), out), (xt.grad, dx),
                 (bn.running_mean, upd["batch_stats"]["mean"]),
                 (bn.running_var, upd["batch_stats"]["var"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("weighted", [False, True])
def test_cross_entropy(rng, weighted):
    logits = rng.standard_normal((6, 2)).astype(np.float32)
    labels = np.array([0, 1, 1, 0, 1, 1])
    w = np.array([0.3, 1.7], np.float32) if weighted else None
    for reduce in (True, False):
        ref = j_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                              None if w is None else jnp.asarray(w), reduce)
        got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                            w, reduce)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-7)


def test_dropout_from_a_generator():
    """Reproducible from a seeded generator; about p of the units zeroed,
    the rest scaled by 1 / (1 - p); identity outside training."""
    x = torch.ones(200, 500)
    a = dropout(x, 0.3, True, torch.Generator().manual_seed(7))
    b = dropout(x, 0.3, True, torch.Generator().manual_seed(7))
    c = dropout(x, 0.3, True, torch.Generator().manual_seed(8))
    assert torch.equal(a, b) and not torch.equal(a, c)
    zeroed = float((a == 0).float().mean())
    assert abs(zeroed - 0.3) < 0.01  # 1e5 draws: 7 standard deviations
    torch.testing.assert_close(a[a != 0], torch.full_like(a[a != 0], 1 / 0.7))
    assert dropout(x, 0.3, False, None) is x
    assert dropout(x, 0.0, True, None) is x
