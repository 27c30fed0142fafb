"""Data-parallel training of the port on the CPU: W = 2 Gloo ranks.

Each rank is a subprocess (`tests/_torch_dp_worker.py`, which imports no
jax), started once for the module: one SGD (lr 1) step of a small ModelAd
(dim 16, one transformer layer, no augmentation or dropout) from the JAX
weights (`state_dict_from_jax`) on its half of a global batch of 8, the
same step on a ragged batch (4 real samples padded to 8 with a mask: rank
1 holds only padding) through the masked-BatchNorm step, the eval step on
that batch, both feeds over a synthetic tree, and the all-reduce's
backward. Held:

- each step against the JAX package's data-2 `shard_map` step on the
  conftest's virtual devices (its plain XLA path: the kernels have their
  own parity tests; the masked one with `mask_bn=True`) under the rule of
  tests/test_torch_train.py: losses and logits within 1e-4, every update
  and running statistic within 1e-4 of max(1, its magnitude). On the
  ragged batch the PET encoder's updates named in `NOISY` are
  ill-conditioned: 3 JAX steps on inputs perturbed by 1e-6 move them by
  more than that rule (the stem's by 7e-3: 4 real samples in the masked
  BatchNorm), on JAX's Pallas path as on its plain one. Those alone get
  3x the measured spread on top (the conditioning rule of
  tests/test_torch_fullres_step.py); the forward's logits and running
  statistics, where a fault of the masked synced BatchNorm shows first,
  and every other tensor stay at 1e-4;
- against the port's single-process step on the global batch: within
  1e-5 of max(1, each tensor's magnitude);
- the two ranks' parameters and running statistics bit-identical after
  the step, and the gradient with a psum alone exactly W times the pmean'd
  one (as tests/test_parallel.py pins the W factor for JAX);
- the eval step's MetricState against JAX's data-2 eval step: the counts
  equal, on both ranks;
- every batch of `DeviceCachedFeed` (row-sharded, assembled by an
  all-to-all) and `DeviceFeed` on rank r bit for bit the r-th half of the
  JAX package's feeds sharded over a data-2 mesh, for two epochs with a
  ragged last batch;
- `torch.distributed.nn.functional.all_reduce`'s backward all-reduces the
  cotangent (psum's transpose), which the steps rely on;
- the ranks meet through torchrun's environment too
  (`coordinator_address='auto'`), and a single process joins no group.

Every rank has a time limit and is killed on failure (`launch`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_dp_worker import Ranks
from tests._torch_parity import randomize_bn
from transmf_ad_tpu.data import device_cache as j_cache
from transmf_ad_tpu.data import pipeline as j_pipeline
from transmf_ad_tpu.data.adni import ADNI as J_ADNI
from transmf_ad_tpu.models import build_model as j_build_model
from transmf_ad_tpu.parallel import batch_sharding, make_mesh, shard_state
from transmf_ad_tpu.train import MetricState as JMetricState
from transmf_ad_tpu.train import build_optimizer as j_build_optimizer
from transmf_ad_tpu.train import create_state as j_create_state
from transmf_ad_tpu.train import make_eval_step as j_make_eval_step
from transmf_ad_tpu.train import make_train_step as j_make_train_step
from transmf_ad_tpu_torch.data.pipeline import pad_batch
from transmf_ad_tpu_torch.models import build_model
from transmf_ad_tpu_torch.train import create_state, make_train_step
from transmf_ad_tpu_torch.utils.weights import state_dict_from_jax

W = 2
KW = dict(dim=16, depth=1, heads=2, dim_head=8, mlp_dim=32, head_dropout=0.0)
BATCH, SHAPE = 8, (33, 19, 17)
FEED_BATCH, FEED_SEED = 3, 7  # 8 ADCN pairs: 3, 3 and a ragged 2, each
# padded to 4 (a multiple of W)


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


def _batches():
    rng = np.random.default_rng(3)
    full = {"MRI": rng.standard_normal((BATCH, *SHAPE)).astype(np.float32),
            "PET": rng.standard_normal((BATCH, *SHAPE)).astype(np.float32),
            "label": (np.arange(BATCH) % 2).astype(np.int32)}
    ragged = pad_batch({k: v[:BATCH // 2] for k, v in full.items()}, BATCH)
    return {"full": full, "ragged": ragged}


@pytest.fixture(scope="module")
def jax_ad():
    """(JAX ModelAd on its plain path with BatchNorm synced over 'data',
    its randomised variables)."""
    x = jnp.zeros((1, 16, 16, 16, 1), jnp.float32)
    v = jax.jit(j_build_model("ad", use_pallas=False, **KW).init)(
        jax.random.key(2), x, x)
    model = j_build_model("ad", use_pallas=False, axis_name="data", **KW)
    return model, randomize_bn(v, seed=4)


@pytest.fixture(scope="module")
def started(jax_ad, adni_root, tmp_path_factory):
    """The ranks, started; they run while the JAX steps compile."""
    _, v = jax_ad
    d = tmp_path_factory.mktemp("dp")
    torch.save({k: torch.from_numpy(np.asarray(t)) for k, t in
                state_dict_from_jax(v, "ad").items()}, d / "w.pt")
    jobs = []
    for name, batch in _batches().items():
        np.savez(d / f"{name}.npz", **batch)
        jobs.append({"name": name, "kind": "step", "model": "ad",
                     "model_kw": KW, "weights": str(d / "w.pt"),
                     "batch": str(d / f"{name}.npz"),
                     "mask_bn": name == "ragged"})
    jobs.append({"name": "eval", "kind": "eval", "model": "ad",
                 "model_kw": KW, "weights": str(d / "w.pt"),
                 "batch": str(d / "ragged.npz")})
    jobs.append({"name": "feeds", "kind": "feeds", "root": adni_root,
                 "indices": list(range(8)), "batch_size": FEED_BATCH,
                 "pad_to": 4, "seed": FEED_SEED})
    jobs.append({"name": "allreduce", "kind": "allreduce"})
    ranks = Ranks(jobs, str(d / "out"), world=W, timeout=150)
    yield ranks
    for p in ranks.procs:  # a failed test must not leave a rank running
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def runs(started, jax_steps):
    """Every job's results on both ranks, {(job, rank): dict}."""
    return started.wait()


def _unit_close(got, ref, rel, what, noise=0.0):
    """max |got - ref| <= rel * max(1, max |ref|) + 3 * noise."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    tol = rel * max(1.0, float(np.abs(ref).max())) + 3.0 * noise
    err = float(np.abs(got - ref).max())
    if noise:
        print(f"{what}: error {err:.3e}, tolerance {tol:.3e} "
              f"(3 x the spread {noise:.3e})")
    assert err <= tol, f"{what}: {err} > {tol} (3 x {noise} of it the spread)"


def _port_sd(v):
    return {k: torch.from_numpy(np.asarray(t))
            for k, t in state_dict_from_jax(v, "ad").items()}


DRAWS, EPS = 3, 1e-6  # the conditioning probe's JAX steps
# The ragged batch's updates whose spread over the probe's JAX steps
# exceeds 1e-4 of their scale, with the spread measured on JAX's plain
# path (its Pallas path, in interpret mode, gives spreads of the same size:
# the stem's 6.9e-3): the only tensors held with the spread added.
NOISY = {"pet_cnn.conv1.0.weight": 7.0e-3, "pet_cnn.conv1.1.weight": 1.5e-4,
         "pet_cnn.conv2.0.weight": 2.3e-4, "pet_cnn.conv2.3.weight": 2.2e-4,
         "pet_cnn.conv2.4.weight": 1.0e-4, "pet_cnn.conv3.0.weight": 1.7e-4,
         "pet_cnn.conv3.3.weight": 1.5e-4, "pet_cnn.conv4.0.weight": 1.3e-4,
         "D.0.weight": 1.1e-4}


@pytest.fixture(scope="module")
def jax_steps(jax_ad):
    """The JAX package's data-2 shard_map step on each batch: (aux, the
    port state_dict after it, {name in NOISY: the largest distance of the
    state after a step on perturbed inputs from it}, measured on the
    ragged batch alone)."""
    model, v = jax_ad
    mesh = make_mesh({"data": W})
    tx = j_build_optimizer("SGD", 1.0, milestones=())[0]
    x = jnp.zeros((1, 16, 16, 16, 1), jnp.float32)
    out = {}
    for name, batch in _batches().items():
        step = j_make_train_step(donate=False, mesh=mesh,
                                 mask_bn=name == "ragged")

        def run(b):
            state = shard_state(j_create_state(
                model, tx, [x, x], jax.random.key(0)).replace(
                    params=v["params"], batch_stats=v["batch_stats"]), mesh)
            new, aux = step(state, {k: jax.device_put(a, batch_sharding(mesh))
                                    for k, a in b.items()},
                            jax.random.key(1))
            return aux, _port_sd({"params": new.params,
                                  "batch_stats": new.batch_stats})

        aux, after = run(batch)
        rng = np.random.default_rng(5)
        spread = {k: 0.0 for k in NOISY} if name == "ragged" else {}
        for _ in range(DRAWS if spread else 0):
            _, other = run({k: (a * (1 + EPS * rng.standard_normal(a.shape))
                                ).astype(np.float32)
                            if k in ("MRI", "PET") else a
                            for k, a in batch.items()})
            for k in spread:
                spread[k] = max(spread[k],
                                float((other[k] - after[k]).abs().max()))
        out[name] = ({k: np.asarray(a) for k, a in aux.items()}, after,
                     spread)
    return out


def _rows(runs, name, key):
    return np.concatenate([runs[name, r]["aux"][key].numpy()
                           for r in range(W)])


@pytest.mark.parametrize("name", ["full", "ragged"])
def test_dp_step_matches_jax(name, runs, jax_steps, jax_ad):
    aux, ref, spread = jax_steps[name]
    for k in ("loss", "ce_loss", "ad_loss"):
        for r in range(W):
            np.testing.assert_allclose(runs[name, r]["aux"][k].numpy(),
                                       aux[k], rtol=1e-4, atol=1e-4,
                                       err_msg=f"{k} rank {r}")
    for k in ("logits", "d_mri", "d_pet"):
        np.testing.assert_allclose(_rows(runs, name, k), aux[k], rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    for k in ("label", "mask"):
        np.testing.assert_array_equal(_rows(runs, name, k), aux[k])
    before = _port_sd(jax_ad[1])
    got = runs[name, 0]["after"]
    assert set(got) == set(ref)
    for k in ref:
        if "running" in k:
            _unit_close(got[k], ref[k], 1e-4, k)
        else:
            _unit_close(got[k] - before[k], ref[k] - before[k], 1e-4, k,
                        spread.get(k, 0.0))


@pytest.mark.parametrize("name", ["full", "ragged"])
def test_dp_step_matches_single_process(name, runs, jax_ad):
    """The port's step on the whole global batch in one process: the same
    losses, updates and running statistics within 1e-5."""
    before = _port_sd(jax_ad[1])
    model = build_model("ad", **KW)
    model.load_state_dict(before)
    aux = make_train_step(mask_bn=name == "ragged")(
        create_state(model, "cpu", name="SGD", lr=1.0, milestones=()),
        _batches()[name])
    for k in ("loss", "ce_loss", "ad_loss"):
        _unit_close(runs[name, 0]["aux"][k].numpy(), aux[k].numpy(), 1e-5, k)
    np.testing.assert_allclose(_rows(runs, name, "logits"),
                               aux["logits"].numpy(), rtol=1e-5, atol=1e-5)
    got, ref = runs[name, 0]["after"], model.state_dict()
    for k in ref:
        if "running" in k:
            _unit_close(got[k], ref[k], 1e-5, k)
        else:
            _unit_close(got[k] - before[k], ref[k] - before[k], 1e-5, k)


@pytest.mark.parametrize("name", ["full", "ragged"])
def test_dp_ranks_stay_bit_identical(name, runs):
    a, b = runs[name, 0]["after"], runs[name, 1]["after"]
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert runs[name, 0]["aux"]["loss"] == runs[name, 1]["aux"]["loss"]


@pytest.mark.parametrize("name", ["full", "ragged"])
def test_psum_gradient_is_w_times_pmean(name, runs):
    """Every rank holds a replicated global loss; through the all-reduce's
    transpose each rank's local gradient is that of the sum of the W loss
    copies, so the gradients psum'd alone are W times the pmean'd ones,
    exactly, and the pmean'd ones are the global batch's (the updates
    above)."""
    for r in range(W):
        res = runs[name, r]
        assert torch.equal(res["psum"], W * res["pmean"]), r
        assert res["pmean"].abs().max() > 0


def test_dp_eval_step_counts_equal_jax(runs, jax_ad):
    model, v = jax_ad
    mesh = make_mesh({"data": W})
    batch = _batches()["ragged"]
    tx = j_build_optimizer("SGD", 1.0, milestones=())[0]
    x = jnp.zeros((1, 16, 16, 16, 1), jnp.float32)
    state = shard_state(j_create_state(model, tx, [x, x], jax.random.key(0))
                        .replace(params=v["params"],
                                 batch_stats=v["batch_stats"]), mesh)
    placed = {k: jax.device_put(b, batch_sharding(mesh))
              for k, b in batch.items()}
    ms, out = j_make_eval_step(mesh=mesh)(state, JMetricState.zero(), placed)
    for r in range(W):
        got = runs["eval", r]["metrics"]
        for k in ("correct", "total", "batches", "confusion"):
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(getattr(ms, k)),
                                          err_msg=f"{k} rank {r}")
        np.testing.assert_allclose(got["loss_sum"].numpy(),
                                   np.asarray(ms.loss_sum), rtol=1e-4)
    probs = np.concatenate([runs["eval", r]["out"]["probs"].numpy()
                            for r in range(W)])
    np.testing.assert_allclose(probs, np.asarray(out["probs"]), atol=1e-4)


@pytest.mark.parametrize("feed", ["cached", "stream"])
def test_dp_feeds_equal_jax_shards(feed, runs, adni_root):
    """Rank r's batches are the r-th halves of the JAX package's feed
    sharded over a data-2 mesh, bit for bit, with the global real count."""
    mesh = make_mesh({"data": W})
    loader = j_pipeline.Loader(
        j_pipeline.VolumeSource(J_ADNI(adni_root, "ADNI.csv",
                                       "ADCN").data_dict, dtype=np.float32),
        batch_size=FEED_BATCH, shuffle=True, seed=FEED_SEED)
    ref = (j_cache.DeviceCachedFeed(loader, mesh, pad_to=4)
           if feed == "cached" else
           j_pipeline.DeviceFeed(loader, batch_sharding(mesh), pad_to=4))
    for epoch in range(2):
        want = [{k: (np.asarray(v) if k != "_n_real" else v)
                 for k, v in b.items()} for b in ref]
        for r in range(W):
            got = runs["feeds", r][feed][epoch]
            assert len(got) == len(want) == 3
            for gb, wb in zip(got, want):
                assert gb.keys() == wb.keys()
                assert gb["_n_real"] == wb["_n_real"]
                for k in ("MRI", "PET", "label", "mask"):
                    half = wb[k][r * 2:(r + 1) * 2]
                    np.testing.assert_array_equal(gb[k].numpy(), half,
                                                  err_msg=f"{k} rank {r}")
                    assert gb[k].shape[0] == 2


def test_torchrun_environment_rendezvous(tmp_path):
    """`coordinator_address='auto'` joins the group from the environment
    torchrun sets (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT)."""
    res = Ranks([{"name": "allreduce", "kind": "allreduce"}],
                str(tmp_path), world=W, timeout=60,
                rendezvous="torchrun").wait()
    for r in range(W):
        assert torch.equal(res["allreduce", r]["y"], torch.full((3,), 3.0))


@pytest.mark.parametrize("args", [
    dict(), dict(num_processes=1), dict(num_processes=1,
                                        coordinator_address="auto")],
    ids=["none", "one_process", "one_process_auto"])
def test_single_process_joins_no_group(args):
    """No flags, or one process without a coordinator: no group, as in the
    JAX package."""
    from transmf_ad_tpu_torch import parallel

    assert parallel.init_distributed(**args, device="cpu") is False
    assert parallel.world_group() is None and parallel.process_count() == 1


def test_processes_without_coordinator_raise():
    """More than one process and no coordinator address: the same
    ValueError as a coordinator without the process count."""
    from transmf_ad_tpu_torch import parallel

    with pytest.raises(ValueError, match="coordinator"):
        parallel.init_distributed(num_processes=2, process_id=0,
                                  device="cpu")
    with pytest.raises(ValueError, match="num_processes"):
        parallel.init_distributed("localhost:1", device="cpu")
    assert parallel.world_group() is None


def test_auto_without_torchrun_raises(monkeypatch):
    from transmf_ad_tpu_torch import parallel

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        parallel.init_distributed("auto", device="cpu")


def test_all_reduce_backward_is_psum_transpose(runs):
    """y = sum over ranks of (r + 1) x; each rank backpropagates sum(y):
    the cotangent all-reduced gives x.grad = W (r + 1) on rank r."""
    for r in range(W):
        res = runs["allreduce", r]
        assert torch.equal(res["y"], torch.full((3,), 3.0))
        assert torch.equal(res["grad"], torch.full((3,), W * (r + 1.0)))
