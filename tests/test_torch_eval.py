"""The port's metrics and eval step against the JAX package's, on the CPU.

`MetricState.update` on random logits, labels, masks and losses over
several seeds: the counts and the confusion matrix equal, the loss sum
within 1e-6 of its magnitude (float32 sums of up to 64 terms in another
order). `confusion_metrics`, `roc_auc` (also against sklearn) and the
streaming AUC: equal up to float64 rounding. `make_eval_step` on one
duplicate-padded, masked batch of a small-width ModelAd and of
`transformer_res`, with the same weights (`state_dict_from_jax`), the JAX
step with its Pallas kernels in interpret mode: probabilities within 1e-4
(both sides compute in float32 and differ in the order of its sums, as in
`tests/_torch_parity.py`), the loss sum within 1e-4 of its magnitude, the
counts and the confusion matrix equal (no sample's two logits lie within
1e-4 of each other, which the test checks). Each model's JAX eval step is
compiled once, in a module fixture.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import model
from transmf_ad_tpu.train import make_eval_step as j_make_eval_step
from transmf_ad_tpu.train import steps as j_steps
from transmf_ad_tpu.train import metrics as j_metrics
from transmf_ad_tpu_torch.data.pipeline import pad_batch
from transmf_ad_tpu_torch.train import create_state, make_eval_step, metrics

FIELDS = ("correct", "total", "loss_sum", "batches", "confusion")


def _compare_states(port, ref, loss_rtol=1e-6):
    for f in FIELDS:
        p = getattr(port, f).numpy()
        r = np.asarray(getattr(ref, f))
        assert p.dtype == np.float32 and p.shape == r.shape, f
        if f == "loss_sum":
            np.testing.assert_allclose(p, r, rtol=loss_rtol,
                                       atol=loss_rtol * abs(float(r)))
        else:
            np.testing.assert_array_equal(p, r, err_msg=f)


def _draw(rng, b):
    logits = rng.standard_normal((b, 2)).astype(np.float32)
    labels = rng.integers(0, 2, b).astype(np.int32)
    mask = (rng.random(b) < 0.7).astype(np.float32)
    loss = rng.random(b).astype(np.float32)
    return logits, labels, mask, loss


# JAX's update, jitted: one compile per batch size and kind, shared by the
# seeds (op by op it would compile every operation of every call)
_j_update = jax.jit(lambda state, *args: state.update(*args))


@pytest.mark.parametrize("seed", range(6))
def test_metric_state_update(seed):
    """three batches: 16 samples with per-sample losses and a mask, 5 with
    a batch-mean loss, 64 with no mask"""
    rng = np.random.default_rng(seed)
    port, ref = metrics.MetricState.zero(), j_metrics.MetricState.zero()
    for kind, b in (("vector", 16), ("scalar", 5), ("no mask", 64)):
        logits, labels, mask, loss = _draw(rng, b)
        if kind == "scalar":
            loss = np.float32(loss.mean())
        if kind == "no mask":
            mask = None
        port = port.update(torch.from_numpy(logits), torch.from_numpy(labels),
                           torch.as_tensor(loss),
                           None if mask is None else torch.from_numpy(mask))
        ref = _j_update(ref, jnp.asarray(logits), jnp.asarray(labels),
                        jnp.asarray(loss),
                        None if mask is None else jnp.asarray(mask))
        _compare_states(port, ref)


def test_metric_state_ties_take_the_first_class():
    """equal logits predict class 0 in both (argmax's first maximum)"""
    logits = np.zeros((3, 2), np.float32)
    labels = np.array([0, 1, 1], np.int32)
    port = metrics.MetricState.zero().update(
        torch.from_numpy(logits), torch.from_numpy(labels), torch.zeros(3))
    ref = j_metrics.MetricState.zero().update(
        jnp.asarray(logits), jnp.asarray(labels), jnp.zeros(3))
    _compare_states(port, ref)
    assert float(port.correct) == 1.0


@pytest.mark.parametrize("c", [
    [[5, 2], [1, 7]], [[3, 0], [0, 4]], [[0, 0], [2, 3]], [[4, 1], [0, 0]],
    [[0, 3], [0, 2]], [[2, 0], [5, 0]],
])
def test_confusion_metrics(c):
    c = np.asarray(c, np.float32)
    got = metrics.confusion_metrics(torch.from_numpy(c))
    want = j_metrics.confusion_metrics(c)
    assert got.keys() == want.keys()
    for k in want:
        assert (np.isnan(got[k]) and np.isnan(want[k])) or got[k] == want[k], k


@pytest.mark.parametrize("seed", range(4))
def test_roc_auc(seed):
    """against JAX's and sklearn's, with ties (scores rounded to 0.1)"""
    from sklearn.metrics import roc_auc_score

    rng = np.random.default_rng(seed)
    n = int(rng.integers(5, 40))
    labels = np.concatenate([[0, 1], rng.integers(0, 2, n - 2)])
    scores = np.round(rng.random(n), 1)
    got = metrics.roc_auc(scores, labels)
    assert got == j_metrics.roc_auc(scores, labels)
    assert got == pytest.approx(roc_auc_score(labels, scores), abs=1e-12)
    assert np.isnan(metrics.roc_auc(scores, np.zeros(n)))


@pytest.mark.parametrize("n_bins", [4, 512])
def test_streaming_auc(n_bins):
    rng = np.random.default_rng(n_bins)
    port = metrics.streaming_auc_init(n_bins)
    ref = j_metrics.streaming_auc_init(n_bins)
    for b in (7, 1, 12):
        probs = rng.random(b).astype(np.float32)
        probs[0] = 1.0  # the last bin is clipped to n_bins - 1
        labels = rng.integers(0, 2, b).astype(np.int32)
        port = metrics.streaming_auc_update(port, torch.from_numpy(probs),
                                            torch.from_numpy(labels))
        ref = j_metrics.streaming_auc_update(ref, jnp.asarray(probs),
                                             jnp.asarray(labels))
    for k in ("pos", "neg"):
        np.testing.assert_array_equal(port[k].numpy(), np.asarray(ref[k]))
    assert metrics.streaming_auc_result(port) == \
        j_metrics.streaming_auc_result(ref)


# --- the eval step --------------------------------------------------------

NO_DROPOUT = dict(head_dropout=0.0)
VOLUME = (33, 19, 17)


def _batch():
    """three real samples padded to four by `pad_batch` (the fourth repeats
    the first, masked out)"""
    rng = np.random.default_rng(21)
    batch = {"MRI": rng.random((3, *VOLUME), np.float32),
             "PET": rng.random((3, *VOLUME), np.float32),
             "label": np.array([1, 0, 1], np.int32)}
    return pad_batch(batch, 4)


@pytest.fixture(scope="module", params=["ad", "transformer_res"])
def evaluated(request):
    """The JAX and the port eval step of one model from the same weights,
    each called twice on the same masked batch: a dict of the metrics and
    outs of both, the port model's logits on the batch, and whether its
    state_dict came through the steps unchanged."""
    name = request.param
    jmodel, v, port = model(name, **NO_DROPOUT)
    adversarial = name == "ad"
    # what the eval step reads of a train state (no optimizer)
    state = j_steps.TrainState(step=jnp.zeros((), jnp.int32),
                               params=v["params"],
                               batch_stats=v["batch_stats"], opt_state=None,
                               apply_fn=jmodel.apply, tx=None)
    j_step = j_make_eval_step(adversarial=adversarial)
    step = make_eval_step(adversarial=adversarial)
    port_state = create_state(port, "cpu", torch.float32)
    before = {k: t.clone() for k, t in port.state_dict().items()}
    batch = _batch()
    ref, port_m = j_metrics.MetricState.zero(), metrics.MetricState.zero()
    outs = []
    for _ in range(2):
        ref, j_out = j_step(state, ref, batch)
        port_m, out = step(port_state, port_m, batch)
        outs.append((j_out, out))
    unchanged = all(torch.equal(t, before[k])
                    for k, t in port.state_dict().items())
    with torch.no_grad():
        logits = port(*(torch.from_numpy(batch[k])[..., None]
                        for k in ("MRI", "PET")), train=False)
    return {"ref": ref, "port": port_m, "outs": outs,
            "logits": logits[0] if adversarial else logits,
            "unchanged": unchanged}


def test_eval_step_probabilities(evaluated):
    for j_out, out in evaluated["outs"]:
        np.testing.assert_allclose(out["probs"].numpy(),
                                   np.asarray(j_out["probs"]), atol=1e-4,
                                   rtol=0)
        assert out["probs"].dtype == torch.float32
        np.testing.assert_array_equal(out["label"].numpy(),
                                      np.asarray(j_out["label"]))
        np.testing.assert_array_equal(out["mask"].numpy(),
                                      np.asarray(j_out["mask"]))
    assert evaluated["outs"][0][1]["mask"].tolist() == [1.0, 1.0, 1.0, 0.0]


def test_eval_step_metrics(evaluated):
    """two batches accumulated: 6 real samples of 8, counts and confusion
    equal, the loss sum within 1e-4"""
    logits = evaluated["logits"]
    gap = (logits[:, 1] - logits[:, 0]).abs()
    assert float(gap.min()) > 1e-4, "a sample on the decision boundary"
    _compare_states(evaluated["port"], evaluated["ref"], loss_rtol=1e-4)
    assert float(evaluated["port"].total) == 6.0
    assert float(evaluated["port"].batches) == 2.0


def test_eval_step_leaves_the_model(evaluated):
    """the eval forward updates nothing: parameters and running statistics
    stay as they were"""
    assert evaluated["unchanged"]
