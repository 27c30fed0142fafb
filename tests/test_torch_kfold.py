"""The port's k-fold driver, options and CLI, on the CPU.

The numpy splits (`kfold_split`, `train_val_split`) give sklearn's
`KFold(shuffle=True, random_state=seed)` and `train_test_split(test_size=0.2,
random_state=seed)` indices, which the card's machine cannot import.
`task_seed`, `dataset_weights` and `transfer_dtype` equal the JAX
package's; `Option().parse` of the reference README's command gives the JAX
package's fields. A whole `run_kfold` of the port (3 folds, 1 + 1 epochs,
dim 16) writes the per-fold logs, one best `.pt` a fold and the aggregate,
through its CLI `main`, and `cli/evaluate.py` scores fold 0 from its best
`.pt` as the fold logged it.
"""

import glob
import os

import numpy as np
import pytest
import torch
from sklearn.model_selection import KFold, train_test_split

from transmf_ad_tpu import config as j_config
from transmf_ad_tpu.train import kfold as j_kfold
from transmf_ad_tpu_torch import config
from transmf_ad_tpu_torch.cli import evaluate, kfold_train_adversarial
from transmf_ad_tpu_torch.train import kfold
from transmf_ad_tpu_torch.train.kfold import (kfold_split, train_val_split,
                                              transfer_dtype)

NOT_PORTED = {"use_pallas"}


@pytest.mark.parametrize("n", [10, 37, 40, 113])
@pytest.mark.parametrize("seed", [1, 42, 996, 7])
@pytest.mark.parametrize("n_splits", [5, 3])
def test_splits_equal_sklearn(n, seed, n_splits):
    ours = list(kfold_split(n, n_splits, seed))
    theirs = list(KFold(n_splits=n_splits, shuffle=True,
                        random_state=seed).split(np.arange(n)))
    assert len(ours) == len(theirs) == n_splits
    for (tr, te), (str_, ste) in zip(ours, theirs):
        np.testing.assert_array_equal(tr, str_)
        np.testing.assert_array_equal(te, ste)
        a, b = train_val_split(tr, seed)
        sa, sb = train_test_split(tr, test_size=0.2, random_state=seed)
        np.testing.assert_array_equal(a, sa)
        np.testing.assert_array_equal(b, sb)


def test_split_sizes_of_the_smoke_run():
    """40 pairs, 5 folds: 8 test, then 25 train and 7 validation."""
    for tr, te in kfold_split(40, 5, 42):
        a, b = train_val_split(tr, 42)
        assert (len(a), len(b), len(te)) == (25, 7, 8)
        assert not set(a) & set(b) and not set(tr) & set(te)


@pytest.mark.parametrize("task", ["ADCN", "pMCIsMCI", "MCICN"])
def test_task_seed(task):
    opt = dict(task=task, randint="False")
    assert kfold.task_seed(config.Options(**opt)) == \
        j_kfold.task_seed(j_config.Options(**opt))
    seeds = {kfold.task_seed(config.Options(task=task, randint="True"))
             for _ in range(20)}
    assert all(1 <= s <= 1000 for s in seeds) and len(seeds) > 1


@pytest.mark.parametrize("labels", [[0, 1, 1, 0, 1], [1, 1], [0]])
def test_dataset_weights(labels, capsys):
    recs = [{"label": v} for v in labels]
    got = kfold.dataset_weights(recs)
    want = j_kfold.dataset_weights(recs)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    out = capsys.readouterr().out.splitlines()
    assert out[:2] == out[2:]


@pytest.mark.parametrize("dtype", [None, "float32", "bfloat16"])
@pytest.mark.parametrize("feed_dtype", ["auto", "uint8", "float32",
                                        "bfloat16"])
@pytest.mark.parametrize("aug_exact", ["False", "True"])
def test_transfer_dtype(dtype, feed_dtype, aug_exact):
    kw = dict(dtype=dtype, feed_dtype=feed_dtype, aug_exact=aug_exact)
    got = transfer_dtype(config.Options(device="cpu", **kw))
    want = np.dtype(j_kfold.transfer_dtype(j_config.Options(**kw)))
    if got is torch.bfloat16:
        assert want.name == "bfloat16"
    else:
        assert np.dtype(got) == want
    # on the card 'auto' picks bfloat16, as the JAX package does on its own
    # accelerator
    if dtype is None and feed_dtype == "auto" and aug_exact == "False":
        assert transfer_dtype(config.Options()) is torch.bfloat16


def test_options_parse_readme_command(tmp_path, capsys):
    argv = ["--randint", "False", "--aug", "True", "--batch_size", "8",
            "--name", "exp", "--task", "ADCN", "--model", "Transformer",
            "--dataroot", "/data/ADNI", "--checkpoints_dir", str(tmp_path)]
    ours = vars(config.Option().parse(argv))
    theirs = vars(j_config.Option().parse(argv))
    assert ours.pop("device") == "cuda"
    assert ours == {k: v for k, v in theirs.items() if k not in NOT_PORTED}
    opt = config.Options(**ours)
    assert opt.epochs == 40 and opt.aug_bool
    assert os.path.exists(tmp_path / "exp" / "opt.txt")
    assert config.str2bool("True") and not config.str2bool("true")


def test_unported_variants_raise():
    """Every variant of the JAX package is ported: only a name it does not
    know raises, as there."""
    for variant in ("sfcn", "ADVIT", ""):
        with pytest.raises(ValueError, match="unknown variant"):
            kfold._variant_spec(variant, config.Options())
        with pytest.raises(ValueError, match="unknown variant"):
            j_kfold._variant_spec(variant, j_config.Options())


FLAGS = ["--task", "ADCN", "--model", "Transformer", "--batch_size", "2",
         "--aug", "True", "--device", "cpu", "--dim", "16", "--heads", "2",
         "--trans_enc_depth", "1", "--stage1_epochs", "1",
         "--stage2_epochs", "1", "--num_folds", "3", "--name", "run"]


@pytest.fixture(scope="module")
def cli_run(adni_root, tmp_path_factory):
    """The k-fold CLI's whole run: (checkpoints root, its flags, result)."""
    root = tmp_path_factory.mktemp("ckpt")
    flags = FLAGS + ["--dataroot", adni_root, "--checkpoints_dir", str(root)]
    return root, flags, kfold_train_adversarial.main(flags)


def test_run_kfold_cli(cli_run):
    root, _, res = cli_run
    assert len(res["folds"]) == 3 and res["seed"] == 42
    assert res["feeds"] == ["DeviceCachedFeed"] * 3
    for fold in range(3):
        d = root / "run" / str(fold)
        log = (d / "log.txt").read_text()
        for text in ("Training Results - Epoch[2]", "Validation Results",
                     "Test Results", "MRIaccuracy", "HBM dataset cache"):
            assert text in log, (fold, text)
        assert len(glob.glob(str(d / "best_label_net_model_*.pt"))) == 1
    main_log = (root / "run" / "log.txt").read_text()
    assert main_log.count("************Fold") == 3
    assert "************Final Results************" in main_log
    assert main_log.count("+-") == 6
    folds = np.array(res["folds"])
    assert folds.shape == (3, 6)
    np.testing.assert_allclose(res["mean"], np.nanmean(folds, axis=0))


def test_evaluate_cli_scores_fold0(cli_run):
    """`cli/evaluate.py --fold 0` on fold 0's best `.pt`, with the training
    flags, gives the test metrics fold 0 logged: counts equal, loss and
    AUC within 1e-5."""
    root, flags, res = cli_run
    (best,) = glob.glob(str(root / "run" / "0" / "best_label_*.pt"))
    m = evaluate.main(["--checkpoint", best, "--fold", "0", *flags])
    got = [m["loss"], m["accuracy"], m["sen"], m["spe"], m["f1"], m["auc"]]
    want = res["folds"][0]
    np.testing.assert_equal(got[1:5], want[1:5])
    np.testing.assert_allclose([got[0], got[5]], [want[0], want[5]],
                               rtol=0, atol=1e-5)


def test_synthetic_tree_threaded_writes_the_same(tmp_path):
    """`workers` changes how the files are written, not what."""
    from transmf_ad_tpu_torch.data import make_synthetic_adni

    a, b = tmp_path / "a", tmp_path / "b"
    make_synthetic_adni(str(a), n_per_group=3, shape=(9, 10, 8), seed=4)
    make_synthetic_adni(str(b), n_per_group=3, shape=(9, 10, 8), seed=4,
                        workers=4)
    files = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    assert len(files) == 4 * 3 * 2 + 1
    for f in files:
        assert (a / f).read_bytes() == (b / f).read_bytes(), f
