"""The port's drivers of the baselines and the hold-out, on the CPU.

`_variant_spec` of every variant equals the JAX package's dict, and
`partition_dataset` its parts, with no JAX compile. `run_holdout` runs its
three modes ('ADNI' 60/20/20, 'ADNI12' on two CSVs, task 'pretrain' with
no test set) through `cli/train_adversarial.py` on a tiny synthetic tree,
with ModelAd at heads 8 and train / val / test `.npy` snapshots equal to
the JAX partitions. The k-fold CLIs of 'single' (its last train batch
ragged, so the masked step runs, and `cli/evaluate.py --fold 0` gives back
fold 0's logged test metrics), 'advit' (padded to a (32, 32, 79) volume)
and 'mnet' (at the parity tests' reduced geometry) run end to end, and
every CLI defaults to the card.
"""

import dataclasses
import glob
import os

import numpy as np
import pytest
import torch

from transmf_ad_tpu import config as j_config
from transmf_ad_tpu.data.adni import ADNI as JADNI
from transmf_ad_tpu.train import kfold as j_kfold
from transmf_ad_tpu_torch import config
from transmf_ad_tpu_torch.cli import (evaluate, kfold_train_ADVIT,
                                      kfold_train_Mnet, kfold_train_single,
                                      train_adversarial)
from transmf_ad_tpu_torch.train import kfold
from transmf_ad_tpu_torch.train import trainer as trainer_mod

FLAGS = ["--device", "cpu", "--dim", "16",
         "--trans_enc_depth", "1", "--stage1_epochs", "1",
         "--stage2_epochs", "0", "--aug", "False"]
OPTIONS = [dict(), dict(model="CNN", aug="False", optimizer="SGD", lr=0.5,
                        stage1_epochs=3, stage2_epochs=4)]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for the CPU training runs here: beside the other
    test processes of a parallel run, torch's default of a thread per core
    made ADVIT's and Mnet's convs 50-90x slower than alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("variant", ["adversarial", "single", "advit",
                                     "mnet"])
@pytest.mark.parametrize("opt", OPTIONS, ids=["defaults", "changed"])
def test_variant_spec_equals_jax(variant, opt):
    ours = kfold._variant_spec(variant, config.Options(**opt))
    theirs = j_kfold._variant_spec(variant, j_config.Options(**opt))
    assert ours.keys() == theirs.keys()
    for k in theirs:
        assert ours[k] == theirs[k], k


@pytest.mark.parametrize("n", [0, 1, 7, 40, 113])
@pytest.mark.parametrize("seed", [None, 1, 42, 965])
@pytest.mark.parametrize("ratios", [[0.6, 0.2, 0.2], [0.8, 0.2]])
def test_partition_dataset_equals_jax(n, seed, ratios):
    data = [{"i": i} for i in range(n)]
    ours = kfold.partition_dataset(data, ratios, seed=seed)
    theirs = j_kfold.partition_dataset(data, ratios, shuffle=True,
                                       seed=seed)
    if seed is None:  # a fresh draw each: only the sizes agree
        assert [len(p) for p in ours] == [len(p) for p in theirs]
        return
    assert ours == theirs
    assert sorted(d["i"] for d in sum(ours, [])) == list(range(n))


@pytest.fixture
def configs_seen(monkeypatch):
    """The TrainerConfig of every Trainer the drivers build."""
    seen = []
    real = trainer_mod.Trainer.__init__

    def spy(self, cfg, logger=None):
        seen.append(cfg)
        real(self, cfg, logger)

    monkeypatch.setattr(trainer_mod.Trainer, "__init__", spy)
    return seen


def _adni12(root, tmp_path):
    """A copy of the tree with ADNI1 (the first 5 rows of each class) and
    ADNI2 (the rest) modality-complete CSVs."""
    lines = open(os.path.join(root, "ADNI.csv")).read().splitlines()
    head, rows = lines[0], lines[1:]
    first = [r for i, r in enumerate(rows) if i % 4 < 3]
    rest = [r for i, r in enumerate(rows) if i % 4 == 3]
    out = tmp_path / "adni12"
    out.mkdir()
    for mod in ("MRI", "PET"):
        os.symlink(os.path.join(root, mod), out / mod)
    for name, part in (("ADNI1", first), ("ADNI2", rest)):
        (out / f"{name}_modality_complete.csv").write_text(
            "\n".join([head, *part]) + "\n")
    return str(out)


@pytest.mark.parametrize("mode", ["ADNI", "ADNI12", "pretrain"])
def test_run_holdout(mode, adni_root, tmp_path, configs_seen):
    root = _adni12(adni_root, tmp_path) if mode == "ADNI12" else adni_root
    flags = FLAGS + ["--dataroot", root, "--checkpoints_dir",
                     str(tmp_path / "ck"), "--name", "hold", "--batch_size",
                     "2", "--heads", "2", "--task",
                     "pretrain" if mode == "pretrain" else "ADCN"]
    if mode == "ADNI12":
        flags += ["--dataset", "ADNI12"]
    res = train_adversarial.main(flags)
    seed = 1 if mode == "pretrain" else 42  # the task's
    (cfg,) = configs_seen
    assert (cfg.heads, cfg.model, cfg.seed) == (8, "ad", seed)
    run = tmp_path / "ck" / "hold"
    parts = [np.load(run / f"{p}.npy", allow_pickle=True).tolist()
             for p in ("train", "val", "test")]
    if mode == "ADNI12":
        want = j_kfold.partition_dataset(
            JADNI(root, "ADNI1_modality_complete.csv", "ADCN").data_dict,
            [0.8, 0.2], shuffle=True, seed=seed)
        want.append(JADNI(root, "ADNI2_modality_complete.csv",
                          "ADCN").data_dict)
    elif mode == "pretrain":
        want = j_kfold.partition_dataset(
            JADNI(root, "ADNI.csv", "ADCN").data_dict, [0.8, 0.2],
            shuffle=True, seed=965) + [[]]
    else:
        want = j_kfold.partition_dataset(
            JADNI(root, "ADNI.csv", "ADCN").data_dict, [0.6, 0.2, 0.2],
            shuffle=True, seed=seed)
    assert parts == want
    log = (run / "log.txt").read_text()
    assert "Validation Results - Epoch[1]" in log and "Total params" in log
    if mode == "pretrain":
        assert res is None and "Test Results" not in log
    else:
        assert len(res) == 6 and np.isfinite(res[:2]).all()
        assert "Test Results" in log


def _kfold_flags(root, tmp_path, name, *extra):
    return FLAGS + ["--task", "ADCN", "--dataroot", root, "--checkpoints_dir",
                    str(tmp_path / "ck"), "--name", name, "--num_folds", "3",
                    *extra]


def test_kfold_single_ragged_batch_and_evaluate(adni_root, tmp_path,
                                                monkeypatch):
    """ModelSingle on the MRI alone: fold 0 trains on 4 pairs in batches of
    3, so its last batch is ragged and takes the masked step; its best
    `.pt` scored by `cli/evaluate.py --model single --fold 0` gives the
    test metrics the fold logged."""
    calls = []
    real = trainer_mod.make_train_step

    def spy(modalities, adversarial, mask_bn=False, **kw):
        step = real(modalities, adversarial, mask_bn=mask_bn, **kw)

        def run(state, batch):
            calls.append((tuple(modalities), mask_bn,
                          int(np.asarray(batch["mask"].cpu()).sum()),
                          batch["label"].shape[0]))
            return step(state, batch)
        return run

    monkeypatch.setattr(trainer_mod, "make_train_step", spy)
    flags = _kfold_flags(adni_root, tmp_path, "single", "--batch_size", "3",
                         "--folds", "0")
    res = kfold_train_single.main(flags)
    assert len(res["folds"]) == 1
    assert {c[0] for c in calls} == {("MRI",)}
    assert (("MRI",), True, 1, 3) in calls  # the ragged batch, masked
    assert all(not masked for _, masked, n, b in calls if n == b)
    (best,) = glob.glob(str(tmp_path / "ck" / "single" / "0" /
                            "best_label_*.pt"))
    m = evaluate.main(["--checkpoint", best, "--fold", "0", "--model",
                       "single", *flags])
    got = [m["loss"], m["accuracy"], m["sen"], m["spe"], m["f1"], m["auc"]]
    want = res["folds"][0]
    np.testing.assert_equal(got[1:5], want[1:5])
    np.testing.assert_allclose([got[0], got[5]], [want[0], want[5]],
                               rtol=0, atol=1e-5)


def test_kfold_advit_padded(adni_root, tmp_path, monkeypatch):
    """`run_kfold('advit', pad_to_override=(32, 32, 79))`, as the JAX
    package's integration test calls it, and the ADVIT CLI's `main` with
    the same override: the fold trains (Adam 1e-4, no augmentation) and
    tests."""
    opt = config.Option().parse(_kfold_flags(adni_root, tmp_path, "advit",
                                             "--batch_size", "2", "--folds",
                                             "0"))
    res = kfold.run_kfold(opt, variant="advit", pad_to_override=(32, 32, 79))
    assert len(res["folds"]) == 1 and np.isfinite(res["folds"][0][0])
    log = open(tmp_path / "ck" / "advit" / "0" / "log.txt").read()
    assert "Test Results" in log and "learning rate: 9.99999974" in log

    real = kfold._variant_spec
    monkeypatch.setattr(kfold, "_variant_spec", lambda v, o: dict(
        real(v, o), pad_to=(32, 32, 79)))
    res = kfold_train_ADVIT.main(_kfold_flags(
        adni_root, tmp_path, "advit_cli", "--batch_size", "2", "--folds",
        "1"))
    assert len(res["folds"]) == 1


def test_kfold_mnet(adni_root, tmp_path, monkeypatch):
    """The Mnet CLI (SGD with momentum 0.9, lr 1e-3): the fold trains and
    tests. Its volumes are padded to (25, 31, 25) and its spatial stack
    cut to kernel 3, pool 2 here, the geometry of the parity tests: at the
    reference's (91, 109, 91) its long slice convs take minutes of CPU
    under a loaded test run (the card runs that geometry, chip_smoke phase
    15)."""
    real_spec, real_cfg = kfold._variant_spec, kfold._make_trainer_cfg
    monkeypatch.setattr(kfold, "_variant_spec", lambda v, o: dict(
        real_spec(v, o), pad_to=(25, 31, 25)))
    monkeypatch.setattr(kfold, "_make_trainer_cfg", lambda *a: dataclasses
                        .replace(real_cfg(*a), model_kwargs=dict(
                            spatial_kernel=3, spatial_pool=2)))
    res = kfold_train_Mnet.main(_kfold_flags(
        adni_root, tmp_path, "mnet", "--batch_size", "2", "--folds", "0"))
    assert len(res["folds"]) == 1 and np.isfinite(res["folds"][0][0])
    log = open(tmp_path / "ck" / "mnet" / "0" / "log.txt").read()
    assert "Test Results" in log and "learning rate: 0.0010000000" in log


@pytest.mark.parametrize("cli", [kfold_train_single, kfold_train_ADVIT,
                                 kfold_train_Mnet, train_adversarial])
def test_clis_default_to_the_card(cli, adni_root, tmp_path):
    """Without `--device cpu` each CLI trains on the card, and raises
    where there is none."""
    flags = [f for f in _kfold_flags(adni_root, tmp_path, "card")
             if f not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(flags)


def _seed_spies(monkeypatch, mod, seen):
    """Stub a kfold module's partition, volume source, loader and Trainer:
    each records the seed it is given, in the order of the calls."""
    real = mod.partition_dataset

    def partition(data, ratios, *a, **kw):
        seen.append(("partition", kw.get("seed")))
        return real(data, ratios, *a, **kw)

    def loader(*a, **kw):
        if kw.get("shuffle"):  # the train loader: the seeded one
            seen.append(("loader", kw["seed"]))

    class FakeTrainer:
        def __init__(self, cfg, logger=None):
            seen.append(("trainer", cfg.seed))

        def fit(self, *a, **kw):
            return None

        def param_count(self):
            return 0

    monkeypatch.setattr(mod, "partition_dataset", partition)
    monkeypatch.setattr(mod, "VolumeSource", lambda data, **kw: data)
    monkeypatch.setattr(mod, "Loader", loader)
    monkeypatch.setattr(mod, "Trainer", FakeTrainer)


@pytest.mark.parametrize("k", [0, 7, 2024])
def test_holdout_randint_seeds_equal_jax(k, adni_root, tmp_path,
                                         monkeypatch):
    """With --randint True each package's `run_holdout` draws the task
    seed three times, for the partition, the train loader and the Trainer,
    in that order: after the same `random.seed(k)` the packages get the
    same three seeds."""
    import random

    args = dict(dataroot=adni_root, checkpoints_dir=str(tmp_path / "ck"),
                name="seeds", randint="True", task="ADCN", device="cpu")
    ours, theirs = [], []
    _seed_spies(monkeypatch, kfold, ours)
    _seed_spies(monkeypatch, j_kfold, theirs)
    os.makedirs(tmp_path / "ck" / "seeds")
    random.seed(k)
    kfold.run_holdout(config.Options(**args))
    random.seed(k)
    j_kfold.run_holdout(j_config.Options(
        **{a: v for a, v in args.items() if a != "device"}))
    assert [w for w, _ in ours] == ["partition", "loader", "trainer"]
    assert ours == theirs
    assert len({s for _, s in ours}) > 1  # three draws, not one
