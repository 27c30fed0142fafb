"""The port's checkpoints (`train/checkpoint.py`), on the CPU.

Best-checkpoint retention (greater or equal wins, one kept), `find_best`
on `.pt` files, the `latest.pt` round trip of a train state (the generator
included: its draws after the load equal its draws after the save), and the
weight bridge back: a best `.pt` the port writes, read by the JAX package's
`import_torch_checkpoint`, gives exactly the JAX variables
`state_dict_from_jax` started from, for ModelAd and ModelCNNAd. A flax
`.msgpack` is refused with a clear error.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from tests._torch_parity import SMALL, randomize_bn
from transmf_ad_tpu.models import build_model as j_build_model
from transmf_ad_tpu.utils.torch_import import import_torch_checkpoint
from transmf_ad_tpu_torch.models import build_model
from transmf_ad_tpu_torch.train import checkpoint as ckpt
from transmf_ad_tpu_torch.train import create_state, make_train_step
from transmf_ad_tpu_torch.train.trainer import _restore_state, _saveable
from transmf_ad_tpu_torch.utils.weights import state_dict_from_jax


def test_best_retention_greater_or_equal(tmp_path):
    c = ckpt.BestCheckpointer(str(tmp_path))
    t = {"w": torch.ones(3)}
    assert c.maybe_save(t, 0.5, 1) is not None
    assert c.maybe_save(t, 0.4, 2) is None  # worse -> skipped
    assert c.maybe_save(t, 0.5, 3) is not None  # equal -> saved (>=)
    assert c.best_path().endswith("best_label_net_model_3_accuracy=0.5000.pt")
    assert c.maybe_save(t, 0.7, 4) is not None
    assert os.listdir(tmp_path) == ["best_label_net_model_4_accuracy=0.7000.pt"]
    assert c.track(0.6, 5) is None and c.track(0.7, 6) is not None
    assert os.listdir(tmp_path) == ["best_label_net_model_4_accuracy=0.7000.pt"]


def test_find_best_and_load(tmp_path):
    for epoch, score in ((1, 0.25), (2, 0.9), (3, 0.5)):
        torch.save({"w": torch.full((2,), float(epoch))},
                   tmp_path / f"best_label_net_model_{epoch}_"
                              f"accuracy={score:.4f}.pt")
    (tmp_path / "best_label_net_model_9_accuracy=0.9900.msgpack").write_text("")
    path = ckpt.find_best(str(tmp_path))
    assert path.endswith("_2_accuracy=0.9000.pt")
    assert ckpt.load(path)["w"].tolist() == [2.0, 2.0]
    assert ckpt.BestCheckpointer(str(tmp_path)).best_path() == path
    wrapped = tmp_path / "wrapped.pth"
    torch.save({"net_model": {"w": torch.ones(1)}}, wrapped)
    assert ckpt.load(str(wrapped))["w"].tolist() == [1.0]
    with pytest.raises(ValueError, match="msgpack"):
        ckpt.load(str(tmp_path / "best_label_net_model_9_accuracy=0.9900"
                                 ".msgpack"))


def test_latest_round_trip(tmp_path):
    """Save the full state after two Adam steps, draw from the generator,
    load into a fresh state and draw again: model, Adam moments, scheduler,
    step and the draws all equal."""
    torch.manual_seed(0)
    model = build_model("cnn_ad", dim=8)
    state = create_state(model, "cpu", torch.float32, seed=5, name="Adam",
                         lr=1e-3, milestones=(1,), steps_per_epoch=1)
    step = make_train_step(aug_cfg=None)
    rng = np.random.default_rng(0)
    for _ in range(2):
        step(state, {"MRI": rng.random((2, 16, 16, 16), np.float32),
                     "PET": rng.random((2, 16, 16, 16), np.float32),
                     "label": np.array([0, 1], np.int32)})
    ckpt.save_latest(str(tmp_path), {**_saveable(state, full=True),
                                     "epoch": 3})
    assert os.listdir(tmp_path) == ["latest.pt"]
    want = torch.rand(4, generator=state.generator)

    fresh = create_state(build_model("cnn_ad", dim=8), "cpu", torch.float32,
                         seed=99, name="Adam", lr=1e-3, milestones=(1,),
                         steps_per_epoch=1)
    restored = ckpt.load_latest(str(tmp_path))
    assert restored["epoch"] == 3
    _restore_state(fresh, restored)
    assert torch.equal(torch.rand(4, generator=fresh.generator), want)
    assert fresh.step == state.step == 2
    for (k, a), b in zip(state.model.state_dict().items(),
                         fresh.model.state_dict().values()):
        assert torch.equal(a, b), k
    for pa, pb in zip(state.optimizer.state.values(),
                      fresh.optimizer.state.values()):
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(pa[k], pb[k]), k
    assert fresh.scheduler.state_dict() == state.scheduler.state_dict()
    assert fresh.optimizer.param_groups[0]["lr"] == pytest.approx(1e-4)
    assert ckpt.load_latest(str(tmp_path / "none")) is None


@pytest.mark.parametrize("name", ["ad", "cnn_ad"])
def test_best_pt_reads_back_into_jax(tmp_path, name):
    """JAX variables -> state_dict_from_jax -> the port's model -> the best
    `.pt` the checkpointer writes -> import_torch_checkpoint: the same
    variables, bit for bit, shape-checked against JAX's tree."""
    kw = SMALL if name == "ad" else {"dim": SMALL["dim"]}
    x = jnp.zeros((1, 16, 16, 16, 1), jnp.float32)
    v = jax.jit(j_build_model(name, use_pallas=False, **kw).init)(
        jax.random.key(3), x, x)
    v = randomize_bn(v, seed=1)
    port = build_model(name, **kw)
    port.load_state_dict(state_dict_from_jax(v, name), strict=True)
    state = create_state(port, "cpu", torch.float32)
    path = ckpt.BestCheckpointer(str(tmp_path)).maybe_save(
        _saveable(state), 0.75, 2)
    back = import_torch_checkpoint(path, name, v)
    for col in ("params", "batch_stats"):
        got = traverse_util.flatten_dict(back[col])
        want = traverse_util.flatten_dict(v[col])
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                          err_msg=str(k))
