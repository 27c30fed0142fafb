"""The port's Trainer against the JAX package's, on the CPU.

One fold of 2 epochs of a small ModelAd (dim 16, depth 1, 2 heads) on a
synthetic ADNI tree at 24x28x24 (16 ADCN pairs: 8 train at batch 3, so
the last batch is ragged and takes the masked step, 4 validation, 4 test,
both classes in each), Adam 1e-5 with a milestone after epoch 1 (epoch 2
at 1e-6), augmentation and dropout off, float32. The JAX Trainer runs its
plain path (use_pallas=False, which the port's kernels are held to
elsewhere) on one device; both start from one `.pt` that
`state_dict_from_jax` wrote from JAX's initial variables (pretrained_path
on both sides). The JAX run is one module fixture, shared by the tests.

Held (`_hold`): each epoch's validation metrics and the test res_fold (acc,
sen, spe, f1 equal; loss and AUC within 1e-4 of their magnitude), the best
epoch, the train step count at each validation, and the update that each
epoch leaves in the two output layers (the classifier's fc_cls.8 and the
discriminator's D.3): within 3e-3 of its norm.

Conditioning (ROADMAP.md Queue 3): the two packages differ in the order of
float32 sums, and training BatchNorm over 2-3 samples amplifies that. A
relative change of 1e-6 to the initial weights moves the port's own
encoder updates by 1% after 3 SGD steps at lr 1e-3; between the packages
the encoder updates differ by 7% at Adam 1e-5 and by up to 50% at SGD 1e-3,
and the validation losses drift apart as the rate grows (3e-6 at Adam 1e-5,
7e-5 at 1e-4, 1.4e-3 at 1e-3). The validation metrics alone cannot tell
the optimizer's work apart at 1e-5: with no optimizer step at all the
losses stay within 1e-4 of JAX's, since BatchNorm's running statistics,
not the weights, make most of their change between epochs. The output
layers are well conditioned: their updates agree to 2e-4 (fc_cls.8) and
4e-5 (D.3), and a fault of the loop moves them by 1.5e-2 or more.
`test_hold_catches_a_planted_fault` plants one fault at a time (an
optimizer step skipped or doubled, the ragged batch's masked step never
taken, the milestone a step early or late) and requires `_hold` to fail.
The inputs are fixed by the tree's seed (0) and the loader's seed (3), and
a sample whose two logits lie within rounding of each other could be
classed either way: the test checks that no evaluated sample lies within
1e-3 of a tie, so a count that differs is a fault.

Also: the resume of a 1-epoch run (restored step, Adam moments,
scheduler and generator equal the saved ones, and it starts at the epoch
the JAX Trainer's resume of its own 1-epoch run starts at),
`evaluate_from_checkpoint` on the port's best `.pt` against JAX's on the
same file, `_pad_eval_batch`'s zero padding against JAX's, the feed
selection, and the unported fields raising.
"""

import copy
import dataclasses
import glob
import os
import re
import shutil
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmf_ad_tpu.data import pipeline as j_pipeline
from transmf_ad_tpu.data.adni import ADNI as J_ADNI
from transmf_ad_tpu.models import build_model as j_build_model
from transmf_ad_tpu.train import trainer as j_trainer
from transmf_ad_tpu_torch.data import (ADNI, DeviceCachedFeed, DeviceFeed,
                                       HybridCachedFeed, Loader,
                                       VolumeSource, make_synthetic_adni)
from transmf_ad_tpu_torch.models import build_model
from transmf_ad_tpu_torch.train import checkpoint as ckpt
from transmf_ad_tpu_torch.train import trainer as t_trainer
from transmf_ad_tpu_torch.train.trainer import Trainer, TrainerConfig
from transmf_ad_tpu_torch.utils.weights import state_dict_from_jax

ARCH = dict(dim=16, depth=1, heads=2, dropout=0.0)
RUN = dict(model="ad", optimizer="Adam", lr=1e-5, milestones=(1,),
           epochs=2, aug=False,
           seed=42, dtype="float32", progress=False,
           model_kwargs={"head_dropout": 0.0}, **ARCH)
# the tree holds 8 CN (rows 0-7), then 8 AD pairs: both classes in each
# split
TRAIN = [0, 8, 1, 9, 2, 10, 3, 11]
VAL, TEST = [4, 12, 5, 13], [6, 14, 7, 15]
BATCH, LOADER_SEED = 3, 3
REL = 1e-4
# the classifier's and the discriminator's output layers, and the bound on
# the relative difference of their per-epoch updates (see the module)
HEADS, UPDATE_REL = ("fc_cls.8.weight", "D.3.weight"), 3e-3


def _loaders(mod, root, **src_kw):
    adni = (ADNI(root, task="ADCN") if mod is None
            else J_ADNI(root, "ADNI.csv", "ADCN"))
    pipe = j_pipeline if mod is not None else None
    Src = pipe.VolumeSource if pipe else VolumeSource
    Ld = pipe.Loader if pipe else Loader
    src = Src(adni.data_dict, **src_kw)
    return (Ld(src, TRAIN, BATCH, shuffle=True, seed=LOADER_SEED),
            Ld(src, VAL, BATCH), Ld(src, TEST, BATCH))


def _recording(trainer, weights):
    """Wrap the trainer's `evaluate`, so every validation (and the test)
    is recorded with what `weights(trainer)` gives just before it: the
    step and the weights by the port's names. Returns the two lists."""
    calls, snaps, inner = [], [], trainer.evaluate

    def evaluate(loader):
        snaps.append(weights(trainer))
        m = inner(loader)
        calls.append(m)
        return m

    trainer.evaluate = evaluate
    return calls, snaps


def _jax_weights(t):
    st = t.state
    return int(st.step), state_dict_from_jax(
        {"params": st.params, "batch_stats": st.batch_stats}, "ad")


def _port_weights(t):
    return t.state.step, {k: v.detach().clone()
                          for k, v in t.state.model.state_dict().items()}


def _best_epoch(save_dir, suffix):
    (path,) = glob.glob(os.path.join(save_dir, f"best_label_*{suffix}"))
    return int(re.search(r"model_(\d+)_", path).group(1)), path


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX fold: its tree, the shared initial `.pt` (and its state_dict),
    the JAX trainer (compiled), its recorded evaluations and weights,
    res_fold, the best epoch, and a copy of the latest.msgpack it saved
    after epoch 1."""
    tmp = tmp_path_factory.mktemp("trainer")
    root = make_synthetic_adni(str(tmp / "adni"), n_per_group=8,
                               shape=(24, 28, 24), groups=("CN", "AD"),
                               seed=0)
    x = jnp.zeros((1, 16, 16, 16, 1), jnp.float32)
    v = jax.jit(j_build_model("ad", use_pallas=False, head_dropout=0.0,
                              **{k: ARCH[k] for k in ("dim", "depth",
                                                      "heads")}).init)(
        jax.random.key(5), x, x)
    port = build_model("ad", head_dropout=0.0, **ARCH)
    port.load_state_dict(state_dict_from_jax(v, "ad"), strict=True)
    init = str(tmp / "init.pt")
    torch.save(port.state_dict(), init)

    cfg = j_trainer.TrainerConfig(save_dir=str(tmp / "jax"),
                                  use_pallas=False, data_parallel=False,
                                  pretrained_path=init, save_latest_every=1,
                                  **RUN)
    jt = j_trainer.Trainer(cfg)
    resume_dir = tmp / "jax_resume"
    resume_dir.mkdir()

    def weights(t):
        if len(snaps) == 1:  # epoch 2's validation: epoch 1's latest
            shutil.copy(os.path.join(cfg.save_dir, "latest.msgpack"),
                        resume_dir)
        return _jax_weights(t)

    calls, snaps = _recording(jt, weights)
    res = jt.fit(*_loaders(j_pipeline, root))
    return SimpleNamespace(root=root, init=init, tmp=tmp, jt=jt,
                           init_sd=port.state_dict(), calls=calls,
                           snaps=snaps, res=res, resume_dir=str(resume_dir),
                           best=_best_epoch(cfg.save_dir, ".msgpack")[0])


def _port_fit(run, save_dir):
    """One port Trainer's fit of the fold, recorded as the JAX one is."""
    cfg = TrainerConfig(save_dir=str(save_dir), device="cpu",
                        pretrained_path=run.init, **RUN)
    t = Trainer(cfg)
    calls, snaps = _recording(t, _port_weights)
    res = t.fit(*_loaders(None, run.root))
    return SimpleNamespace(trainer=t, calls=calls, snaps=snaps, res=res,
                           cfg=cfg, best=_best_epoch(cfg.save_dir, ".pt"))


@pytest.fixture(scope="module")
def port_run(run):
    return _port_fit(run, run.tmp / "port")


def _close(got, want, what):
    assert abs(got - want) <= REL * max(1.0, abs(want)), (what, got, want)


def _same_metrics(got, want, what):
    for k in ("accuracy", "sen", "spe", "f1"):
        np.testing.assert_equal(got[k], want[k], err_msg=f"{what} {k}")
    np.testing.assert_array_equal(got["confusion"], want["confusion"])
    _close(got["loss"], want["loss"], f"{what} loss")
    if np.isnan(want["auc"]):
        assert np.isnan(got["auc"])
    else:
        _close(got["auc"], want["auc"], f"{what} auc")


def _hold(port, ref, init):
    """What the port's fit must give to match the JAX fit `ref` (see the
    module); raises AssertionError at the first difference."""
    assert len(ref.calls) == len(port.calls) == 3  # 2 epochs + test
    for epoch, (got, want) in enumerate(zip(port.calls, ref.calls), 1):
        _same_metrics(got, want, f"epoch {epoch}" if epoch < 3 else "test")
    np.testing.assert_equal(port.res[1:5], ref.res[1:5])
    _close(port.res[0], ref.res[0], "res_fold loss")
    _close(port.res[5], ref.res[5], "res_fold auc")
    assert port.best[0] == ref.best
    for epoch in (1, 2):
        (step, got), (want_step, want) = (port.snaps[epoch - 1],
                                          ref.snaps[epoch - 1])
        assert step == want_step, ("step", epoch, step, want_step)
        for k in HEADS:
            d_want = want[k] - init[k]
            rel = float((got[k] - init[k] - d_want).norm() / d_want.norm())
            assert rel <= UPDATE_REL, ("update", epoch, k, rel)


def test_fit_matches_jax(run, port_run):
    _hold(port_run, run, run.init_sd)
    # the run moves what it holds: the two validations differ many times
    # over the tolerance
    e1, e2 = run.calls[:2]
    assert abs(e1["loss"] - e2["loss"]) > 10 * REL
    assert abs(e1["auc"] - e2["auc"]) > 10 * REL


def _nth_step(n, fault):
    """Adam.step with its `n`-th call (from 1) replaced by `fault`."""
    inner, calls = torch.optim.Adam.step, []

    def step(self, *a, **k):
        calls.append(None)
        if len(calls) == n:
            return fault(lambda: inner(self, *a, **k))
        return inner(self, *a, **k)

    return step


def _shifted_milestones(by):
    inner = torch.optim.lr_scheduler.MultiStepLR
    return lambda opt, milestones, gamma=0.1: inner(
        opt, [m + by for m in milestones], gamma)


def _unmasked(inner):
    return lambda *a, mask_bn=False, **k: inner(*a, mask_bn=False, **k)


FAULTS = {
    "step 4 skipped": (torch.optim.Adam, "step",
                       lambda: _nth_step(4, lambda step: None)),
    "last step skipped": (torch.optim.Adam, "step",
                          lambda: _nth_step(6, lambda step: None)),
    "step 4 doubled": (torch.optim.Adam, "step",
                       lambda: _nth_step(4, lambda step: (step(), step()))),
    "masked step never taken": (t_trainer, "make_train_step",
                                lambda: _unmasked(t_trainer.make_train_step)),
    "milestone a step early": (torch.optim.lr_scheduler, "MultiStepLR",
                               lambda: _shifted_milestones(-1)),
    "milestone a step late": (torch.optim.lr_scheduler, "MultiStepLR",
                              lambda: _shifted_milestones(1)),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_hold_catches_a_planted_fault(run, fault, monkeypatch, tmp_path):
    """The port's fit with one fault of its loop planted fails `_hold`."""
    owner, name, make = FAULTS[fault]
    monkeypatch.setattr(owner, name, make())
    faulty = _port_fit(run, tmp_path)
    with pytest.raises(AssertionError):
        _hold(faulty, run, run.init_sd)


def test_no_sample_near_a_tie(run, port_run):
    """The conditioning rule: every evaluated sample's two logits lie more
    than 1e-3 apart, so rounding cannot flip a count (see the module)."""
    t = port_run.trainer
    for loader in _loaders(None, run.root)[1:]:
        for b in loader:
            with torch.inference_mode():
                logits = t.state.model(
                    *(torch.as_tensor(b[k])[..., None]
                      for k in ("MRI", "PET")))[0]
            assert float((logits[:, 1] - logits[:, 0]).abs().min()) > 1e-3


def test_fit_log_and_feeds(port_run):
    t = port_run.trainer
    assert isinstance(t.train_feed, DeviceCachedFeed)
    assert isinstance(t.val_feed, DeviceCachedFeed)
    log = open(os.path.join(port_run.cfg.save_dir, "log.txt")).read()
    for text in ("Load pre-training model", "HBM dataset cache: train",
                 "Current learning rate: 9.999999747378752e-06",
                 "Training Results - Epoch[2] ", "MRIaccuracy",
                 "Validation Results - Epoch[1] ", "Load best model",
                 "Test Results", "volumes/s)"):
        assert text in log, text


def test_param_count_matches_jax(run, port_run):
    assert port_run.trainer.param_count() == run.jt.param_count()


def test_evaluate_from_checkpoint(run, port_run):
    """The port's best `.pt`, scored by a fresh port Trainer and by the JAX
    trainer (which reads it through import_torch_checkpoint): the fit's
    test metrics on both."""
    _, path = port_run.best
    cfg = TrainerConfig(save_dir=str(run.tmp / "eval"), device="cpu",
                        **RUN)
    test = _loaders(None, run.root)[2]
    got = Trainer(cfg).evaluate_from_checkpoint(test, path)
    _same_metrics(got, port_run.calls[-1], "port from .pt")
    run.jt.load_checkpoint(path)
    want = run.jt.evaluate(_loaders(j_pipeline, run.root)[2])
    _same_metrics(got, want, "jax from the port's .pt")
    with pytest.raises(ValueError, match="msgpack"):
        Trainer(cfg).evaluate_from_checkpoint(test, "best.msgpack")


class _Stop(Exception):
    pass


def test_resume(run, monkeypatch):
    """One epoch with save_latest_every=1, then a resumed run to 2: right
    after the load the step, Adam moments, scheduler and generator equal
    what was saved; it starts at the epoch where the JAX Trainer's resume
    from the latest.msgpack of its own first epoch starts, and logs epoch
    2 only. The loader's shuffle RNG is not part of the state (as in the
    JAX package): the resumed epoch's order restarts the loader's
    stream."""
    jax_seen = {}

    def jax_spy(engine, loader, max_epochs=1, start_epoch=0):
        jax_seen.update(start=start_epoch, max_epochs=max_epochs)
        raise _Stop  # the start is all that is needed: train nothing

    monkeypatch.setattr(j_trainer.Engine, "run", jax_spy)
    jt = j_trainer.Trainer(j_trainer.TrainerConfig(
        save_dir=run.resume_dir, use_pallas=False, data_parallel=False,
        pretrained_path=run.init, resume=True, **RUN))
    with pytest.raises(_Stop):
        jt.fit(*_loaders(j_pipeline, run.root)[:2])

    save = str(run.tmp / "resume")
    kw = dict(RUN, save_dir=save, device="cpu", pretrained_path=run.init)
    Trainer(TrainerConfig(**dict(kw, epochs=1),
                          save_latest_every=1)).fit(
        *_loaders(None, run.root)[:2])
    saved = ckpt.load_latest(save)
    assert saved["epoch"] == 1 and saved["step"] == 3

    seen = {}
    inner = t_trainer.Engine.run

    def spy(engine, loader, max_epochs=1, start_epoch=0):
        state = trainer.state
        seen.update(start=start_epoch, step=state.step,
                    opt=copy.deepcopy(state.optimizer.state_dict()),
                    sched=state.scheduler.state_dict(),
                    gen=state.generator.get_state().clone())
        return inner(engine, loader, max_epochs, start_epoch)

    monkeypatch.setattr(t_trainer.Engine, "run", spy)
    trainer = Trainer(TrainerConfig(**kw, resume=True))
    train, val, _ = _loaders(None, run.root)
    trainer.fit(train, val)
    # the loader's shuffle drew one permutation: the resumed epoch took the
    # order of a fresh loader's first epoch, not the uninterrupted run's
    # second
    fresh = np.random.default_rng(LOADER_SEED)
    fresh.permutation(len(TRAIN))
    assert train._rng.bit_generator.state == fresh.bit_generator.state
    assert seen["start"] == jax_seen["start"] == 1
    assert jax_seen["max_epochs"] == 2 and seen["step"] == saved["step"]
    assert torch.equal(seen["gen"], saved["generator"])
    assert seen["sched"] == saved["scheduler"]
    for i, st in saved["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(seen["opt"]["state"][i][k], v), (i, k)
    log = open(os.path.join(save, "log.txt")).read()
    assert "Resumed from epoch 1" in log
    resumed = log[log.index("Resumed from epoch 1"):]
    assert "Training Results - Epoch[2]" in resumed
    assert "Epoch[1]" not in resumed
    assert trainer.state.step == 6


def test_pad_eval_batch_zero_pads_like_jax():
    rng = np.random.default_rng(0)
    batch = {"MRI": rng.random((2, 4, 5, 3), np.float32),
             "PET": torch.from_numpy(rng.random((2, 4, 5, 3), np.float32)
                                     ).to(torch.bfloat16),
             "label": np.array([1, 0], np.int32)}
    port = Trainer.__new__(Trainer)
    port.modalities = ("MRI", "PET")
    got = port._pad_eval_batch(batch, 4)
    ref = dict(batch, PET=batch["PET"].float().numpy())
    want = j_trainer.Trainer._pad_eval_batch(
        SimpleNamespace(modalities=("MRI", "PET")), ref, 4)
    for k in ("MRI", "label", "mask"):
        np.testing.assert_array_equal(np.asarray(got[k]), want[k])
        assert np.asarray(got[k]).dtype == want[k].dtype
    assert got["PET"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["PET"].float().numpy(), want["PET"])
    assert not got["PET"][2:].any() and not got["MRI"][2:].any()
    assert got["mask"].tolist() == [1.0, 1.0, 0.0, 0.0]


def test_feed_selection(run, monkeypatch, tmp_path):
    """The JAX package's rule: cached under the budget, hybrid when at
    least two batches' rows fit, streaming otherwise; 'on' over the budget
    and 'on' with aug_exact raise; aug_exact streams."""
    cfg = TrainerConfig(save_dir=str(tmp_path), device="cpu", **RUN)
    t = Trainer(cfg)
    tr, va, _ = _loaders(None, run.root)
    sample = tr.peek()
    assert isinstance(t._train_feeds(tr, va, sample, False)[0],
                      DeviceCachedFeed)
    row = 24 * 28 * 24 * 4 * 2
    monkeypatch.setenv("TRANSMF_CACHE_BUDGET_MB", str(7 * row / 2**20))
    feed, val = t._train_feeds(tr, va, sample, False)
    assert isinstance(feed, HybridCachedFeed) and feed.n_hot == 7
    assert val is va
    monkeypatch.setenv("TRANSMF_CACHE_BUDGET_MB", str(5 * row / 2**20))
    assert isinstance(t._train_feeds(tr, va, sample, False)[0], DeviceFeed)
    t.cfg = TrainerConfig(save_dir=str(tmp_path), device="cpu",
                          device_cache="on", **RUN)
    with pytest.raises(ValueError, match="budget"):
        t._train_feeds(tr, va, sample, False)
    monkeypatch.delenv("TRANSMF_CACHE_BUDGET_MB")
    with pytest.raises(ValueError, match="aug_exact"):
        t._train_feeds(tr, va, sample, True)
    t.cfg = cfg
    assert isinstance(t._train_feeds(tr, va, sample, True)[0], DeviceFeed)


@pytest.mark.parametrize("field", t_trainer.UNPORTED)
def test_unported_flags_raise(field):
    with pytest.raises(NotImplementedError, match="not ported"):
        TrainerConfig(**{field: True})


@pytest.mark.parametrize("field", ["use_pallas", "data_parallel",
                                   "model_parallel", "profile_dir",
                                   "coordinator_address"])
def test_jax_only_fields_are_absent(field):
    """The JAX package's mesh, multi-host, profiler and use_pallas fields
    are not part of the port's config: setting one raises."""
    assert field in {f.name for f in dataclasses.fields(
        j_trainer.TrainerConfig)}
    with pytest.raises(TypeError, match=field):
        TrainerConfig(**{field: None})


def test_defaults_to_the_card():
    assert TrainerConfig().device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Trainer(TrainerConfig(save_dir="unused"))
