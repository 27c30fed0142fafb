"""`Trainer.fit` of the port on W = 2 Gloo ranks, on the CPU.

Two ranks (subprocesses of `tests/_torch_dp_worker.py`, which imports no
jax; the Trainer joins the group from its `coordinator_address`,
`num_processes` and `process_id`) train a small ModelAd for 2 epochs on a
synthetic ADCN tree (6 train pairs at batch 4, so each epoch's second
batch is ragged and rank 1 holds only its padding; 3 validation and 3 test
pairs, padded to 4), with a `latest.pt` each epoch, then resume for a
third epoch. The same fit runs single-process in this process. Held:

- the validation metrics of each epoch, the best epoch and `res_fold` on
  both ranks equal the single-process run's (counts exactly, losses and
  AUC within 1e-5), and the ranks' final parameters are bit-identical;
- only rank 0 opened a file for writing under the run's directory, and
  the directory then holds what the single-process run's holds;
- the resumed run starts at epoch 2 with each rank's own generator, as it
  was when `latest.pt` was written, and the two ranks' generators differ.
"""

import numpy as np
import pytest
import torch

from tests._torch_dp_worker import Ranks
from transmf_ad_tpu_torch.data import (ADNI, Loader, VolumeSource,
                                       make_synthetic_adni)
from transmf_ad_tpu_torch.train.trainer import Trainer, TrainerConfig

W = 2
CFG = dict(model="ad", dim=16, depth=1, heads=2,
           model_kwargs={"head_dropout": 0.0}, optimizer="Adam", lr=1e-5,
           epochs=2, aug=False, seed=42, dtype="float32", progress=False,
           save_latest_every=1)
SPLIT = dict(train=list(range(6)), val=[6, 7, 8], test=[9, 10, 11])
BATCH = 4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this process's own torch work, the module
    fixtures' included (as tests/test_torch_holdout.py does for its
    tests): beside the other test processes of a parallel run, a thread
    per core slows every one of them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_synthetic_adni(str(tmp_path_factory.mktemp("adni")),
                               n_per_group=6, shape=(16, 16, 16), seed=1)


@pytest.fixture(scope="module")
def ranks(tree, tmp_path_factory):
    """The 2-rank fit's results, started before the single-process run."""
    d = tmp_path_factory.mktemp("dpfit")
    job = {"name": "fit", "kind": "fit", "root": tree, "batch_size": BATCH,
           "seed": 3, "cfg": CFG, "save_dir": str(d / "run"), **SPLIT}
    started = Ranks([job], str(d / "out"), world=W, timeout=150)
    yield started
    for p in started.procs:
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def single(tree, tmp_path_factory):
    """The same fit in one process: (validation metrics of each epoch,
    res_fold, final state_dict, the files of its run directory)."""
    save_dir = tmp_path_factory.mktemp("single") / "run"
    source = VolumeSource(ADNI(tree, "ADNI.csv", "ADCN").data_dict,
                          dtype=np.float32)
    loaders = [Loader(source, SPLIT["train"], BATCH, shuffle=True, seed=3),
               Loader(source, SPLIT["val"], BATCH),
               Loader(source, SPLIT["test"], BATCH)]
    trainer = Trainer(TrainerConfig(**CFG, save_dir=str(save_dir),
                                    device="cpu"))
    val = []
    real = trainer.evaluate

    def evaluate(loader):
        m = real(loader)
        val.append({k: v for k, v in m.items() if k != "confusion"})
        return m

    trainer.evaluate = evaluate
    res = trainer.fit(*loaders)
    files = sorted(p.name for p in save_dir.iterdir())
    return val, res, trainer.state.model.state_dict(), files


@pytest.fixture(scope="module")
def runs(ranks, single):
    return ranks.wait()


def _same_metrics(got, want, what):
    for k in want:
        if k in ("loss", "auc", "f1", "sen", "spe"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       atol=1e-6, err_msg=f"{what} {k}")
        else:
            assert got[k] == want[k], f"{what} {k}"


def test_dp_fit_matches_single_process(runs, single):
    val, res, _, _ = single
    assert len(val) == 3  # two validations and the test
    for r in range(W):
        got = runs["fit", r]
        assert len(got["val"]) == len(val)
        for e, (g, w) in enumerate(zip(got["val"], val)):
            _same_metrics(g, w, f"rank {r} evaluation {e}")
        np.testing.assert_allclose(got["res_fold"], res, rtol=1e-5,
                                   atol=1e-6)


def test_dp_fit_ranks_bit_identical(runs, single):
    """(The single-process weights are not a reference: Adam turns the
    rounding-sized gradients of the biases before a BatchNorm into
    lr-sized steps.)"""
    a, b = runs["fit", 0]["after"], runs["fit", 1]["after"]
    assert a.keys() == single[2].keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_dp_fit_only_rank0_writes(runs, single):
    files = single[3]
    assert "log.txt" in files and "latest.pt" in files
    assert sum(f.startswith("best_label_net_model") for f in files) == 1
    assert runs["fit", 1]["written"] == []
    assert runs["fit", 0]["files"] == files
    # latest.pt lands by a rename of latest.pt.tmp; a best checkpoint of an
    # earlier epoch may have been written and removed
    wrote = {f.removesuffix(".tmp") for f in runs["fit", 0]["written"]}
    assert set(files) <= wrote
    assert all(f in files or f.startswith("best_label_net_model")
               for f in wrote), wrote


def test_dp_resume_restores_every_generator(runs):
    gens = [runs["fit", r]["generator"] for r in range(W)]
    assert not torch.equal(gens[0], gens[1])
    for r in range(W):
        resumed = runs["fit", r]["resumed"]
        assert resumed["start_epoch"] == 2
        assert resumed["step"] == 4  # two epochs of two steps
        assert torch.equal(resumed["generator"], gens[r]), r
