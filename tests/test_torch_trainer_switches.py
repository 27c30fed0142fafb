"""The Trainer's profiler window and `debug_nans`, port against the JAX
package, on the CPU.

A synthetic ADNI tree of 8 ADCN pairs at 16^3 trains ModelCNNAd (dim 8)
at batch 2 without shuffling, so each pair enters at a known iteration.

- `debug_nans`: one MRI volume of the tree is NaN. The port's
  `Trainer.fit` raises `FloatingPointError` at the iteration where that
  volume enters; the JAX package's train step (plain XLA path) under
  `jax_debug_nans` raises on the same batch of its own loader over the same
  tree. Neither raises on the clean tree, and the port's clean run ends
  with the same weights with the switch on as off.
- The profiler window: `profile_steps=(2, 4)` writes one Chrome trace into
  `profile_dir` whose iteration ranges are 2 and 3; no trace without
  `profile_dir`; a window still open when `fit` returns is written then.
- The new fields exist in both `TrainerConfig`s with JAX's defaults.
"""

import dataclasses
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmf_ad_tpu.data import pipeline as j_pipeline
from transmf_ad_tpu.data.adni import ADNI as J_ADNI
from transmf_ad_tpu.models import build_model as j_build_model
from transmf_ad_tpu.train import trainer as j_trainer
from transmf_ad_tpu.train.optim import build_optimizer
from transmf_ad_tpu.train.steps import create_state, make_train_step
from transmf_ad_tpu_torch.data import (ADNI, Loader, VolumeSource,
                                       make_synthetic_adni, nifti)
from transmf_ad_tpu_torch.train.trainer import Trainer, TrainerConfig

SHAPE, BATCH = (16, 16, 16), 2
# the tree's 8 ADCN rows, CN then AD, interleaved so every batch holds both
TRAIN = [0, 4, 1, 5, 2, 6, 3, 7]
NAN_ROW = 2  # TRAIN position 4: the first volume of the third batch
NAN_ITERATION = TRAIN.index(NAN_ROW) // BATCH + 1
RUN = dict(model="cnn_ad", dim=8, optimizer="Adam", lr=1e-4, aug=False,
           dtype="float32", progress=False, device="cpu",
           device_cache="off")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the tier runs six test workers at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """(clean tree, the same tree with one NaN voxel in row NAN_ROW's
    MRI). The sources read the volumes as written (`normalize=False`), so
    the NaN reaches the step whatever the decoder's min-max does."""
    tmp = tmp_path_factory.mktemp("switches")
    clean = make_synthetic_adni(str(tmp / "clean"), n_per_group=4,
                                shape=SHAPE)
    bad = make_synthetic_adni(str(tmp / "nan"), n_per_group=4, shape=SHAPE)
    path = ADNI(bad, task="ADCN").data_dict[NAN_ROW]["MRI"]
    vol = nifti.load(path)
    vol[8, 8, 8] = np.nan
    nifti.save(path, vol)
    return clean, bad


def _fit(root, save_dir, epochs=1, **cfg):
    src = VolumeSource(ADNI(root, task="ADCN").data_dict, normalize=False)
    trainer = Trainer(TrainerConfig(save_dir=str(save_dir), epochs=epochs,
                                    **RUN, **cfg))
    trainer.fit(Loader(src, TRAIN, BATCH), Loader(src, [0, 4], BATCH))
    return trainer


def _jax_steps(root):
    """The 1-based batch of the tree at which the JAX train step under
    `jax_debug_nans` raises, or None. The switch checks a jitted call's
    outputs and raises where one holds a NaN, so each batch runs without it
    and, where an output holds a NaN, again under it, from an empty
    dispatch cache (`clear_cache`: once a jitted call has been dispatched,
    jax 0.9 runs its later calls without the check)."""
    src = j_pipeline.VolumeSource(J_ADNI(root, "ADNI.csv", "ADCN").data_dict,
                                  normalize=False)
    model = j_build_model("cnn_ad", dim=8)
    tx, _ = build_optimizer("Adam", 1e-4, steps_per_epoch=4)
    sample = jnp.zeros((BATCH, *SHAPE, 1), jnp.float32)
    state = create_state(model, tx, [sample, sample], jax.random.key(0))
    step = make_train_step(("MRI", "PET"), True, donate=False)
    for i, batch in enumerate(j_pipeline.Loader(src, TRAIN, BATCH), 1):
        batch = {k: jnp.asarray(batch[k]) for k in ("MRI", "PET", "label")}
        new, out = step(state, batch, jax.random.key(i))
        if all(np.isfinite(x).all() for x in jax.tree_util.tree_leaves(
                (new, out)) if jnp.issubdtype(x.dtype, jnp.inexact)):
            state = new
            continue
        step.clear_cache()
        with jax.debug_nans(True):
            try:
                step(state, batch, jax.random.key(i))
            except FloatingPointError:
                return i
        raise AssertionError(f"batch {i}: a NaN, and no FloatingPointError")
    return None


def test_debug_nans_raises_where_the_nan_enters(trees, tmp_path):
    _, bad = trees
    with pytest.raises(FloatingPointError,
                       match=f"iteration {NAN_ITERATION}"):
        _fit(bad, tmp_path / "port", debug_nans=True)
    assert _jax_steps(bad) == NAN_ITERATION


def test_debug_nans_quiet_on_a_clean_tree(trees, tmp_path):
    """Neither package raises on the clean tree; the port's run is the
    same with the switch on as off."""
    clean, _ = trees
    assert _jax_steps(clean) is None
    on = _fit(clean, tmp_path / "on", debug_nans=True)
    off = _fit(clean, tmp_path / "off")
    assert on.state.step == off.state.step == 4
    a, b = on.state.model.state_dict(), off.state.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.is_anomaly_enabled()  # scoped to fit


def test_debug_nans_off_trains_through_a_nan(trees, tmp_path):
    """Without the switch nothing is checked: the NaN reaches the
    weights."""
    _, bad = trees
    t = _fit(bad, tmp_path / "port")
    assert not all(torch.isfinite(p).all() for p in t.state.model.parameters())


def _ranges(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted({e["name"] for e in events
                   if e.get("name", "").startswith("iteration ")})


def test_profile_window_writes_one_trace(trees, tmp_path):
    clean, _ = trees
    out = tmp_path / "trace"
    _fit(clean, tmp_path / "run", epochs=2, profile_dir=str(out),
         profile_steps=(2, 4))
    (path,) = glob.glob(str(out / "*.json"))
    assert os.path.basename(path) == "trace_2_4.json"
    assert _ranges(path) == ["iteration 2", "iteration 3"]


def test_no_trace_without_profile_dir(trees, tmp_path):
    clean, _ = trees
    _fit(clean, tmp_path / "run", profile_steps=(2, 4))
    assert not glob.glob(str(tmp_path / "**" / "*.json"), recursive=True)


def test_open_window_written_when_fit_returns(trees, tmp_path):
    """A window the run does not reach the end of (JAX's would stay
    open) is closed and written when `fit` returns."""
    clean, _ = trees
    out = tmp_path / "trace"
    _fit(clean, tmp_path / "run", epochs=2, profile_dir=str(out),
         profile_steps=(7, 100))
    (path,) = glob.glob(str(out / "*.json"))
    assert os.path.basename(path) == "trace_7_100.json"
    assert _ranges(path) == ["iteration 7", "iteration 8"]


@pytest.mark.parametrize("field", ["profile_dir", "profile_steps",
                                   "debug_nans"])
def test_switch_fields_equal_jax(field):
    """The profiler and NaN-debugging fields are the JAX package's, with
    its defaults."""
    ours = {f.name: f.default for f in dataclasses.fields(TrainerConfig)}
    theirs = {f.name: f.default
              for f in dataclasses.fields(j_trainer.TrainerConfig)}
    assert ours[field] == theirs[field]
