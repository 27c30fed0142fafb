"""The tensor-parallel 'model' axis of the port on the CPU: Gloo ranks.

- The rule: for all 8 models at full width and a model axis of 2 and 4,
  `parallel.param_shardings` names exactly the parameters that the JAX
  package's `param_shardings` column-shards. JAX's parameter tree comes
  from `jax.eval_shape` of the model's init; the port's state_dict, each
  tensor filled with its index, goes through JAX's `map_state_dict` onto
  it, so every JAX leaf names the port tensor it came from.
- The step: one SGD (lr 1) step of a small ModelAd (dim 16, one
  transformer layer of 2 heads) on a global batch of 8 at (33, 19, 17),
  on a data-1 x model-2 mesh (2 ranks) and a data-2 x model-2 mesh (4
  ranks; `tests/_torch_dp_worker.py`, job "tp_step"), with `min_size` 64,
  so that every conv (the stem's too), every dense layer and the heads are
  sharded (asserted: each rank ran attention on 1 of 2 heads). Held
  against the port's one-process step and against the JAX package's step
  on a data-2 x model-2 CPU mesh (Pallas in interpret mode) under the
  fixed rule of tests/test_torch_parallel.py: losses and logits within
  1e-4, every update and running statistic within 1e-4 of max(1, its
  magnitude). (The data-parallel tests hold one process at 1e-5; here the
  input gradient of a sharded layer is the sum of the ranks' shares, whose
  rounding a step of lr 1 moves past 1e-5.) A
  data-1 mesh cannot be the JAX reference: XLA's SPMD partitioner stops
  the JAX step there ("Cross-partition allreduce must be in (partial)
  manual partitioning mode", jax 0.9, its plain path too); JAX's numbers do
  not depend on placement, so the data-2 x model-2 step holds both.
- Every rank's whole state after the step bit-identical; each rank's rows
  of a sharded weight are that rank's rows of the whole.
- The other models and remat: a train-mode forward and backward of
  ModelSingle, ModelCNNAd, ModelTransformer (dim 16), ADVIT (32, 32, 79)
  and Mnet ((25, 31, 25), spatial kernel 3, pool 2), every weight the rule
  names at `min_size` 16 sharded (ADVIT's positional embedding and CLS
  token too), and of ModelAd with `remat=True` and every block recomputed
  (job "tp_grads", data 1 x model 2, batch 8, dropout from a seeded
  generator, every output in the loss): the logits and every gradient
  within 1e-4 of max(1, its magnitude) of one process. (At batch 2 the
  heads' BatchNorm over two samples turns rounding into percents, sharded
  or not.)
- `make_sharded_inference_fn(model_axis=2)` within 1e-4 of one process.
- A `latest.pt` written at model_parallel 2 resumes at 1, and one written
  at 1 resumes at 2: the next epoch's state equals a run that did not
  change layout (1e-5).
- The mesh's errors: a mesh larger or smaller than the world, and a world
  that `model_parallel` does not divide, raise `ValueError`.

The ranks start before the JAX step compiles, so the two overlap.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_dp_worker import Ranks
from tests._torch_parity import randomize_bn
from transmf_ad_tpu.models import build_model as j_build_model
from transmf_ad_tpu.parallel import batch_sharding
from transmf_ad_tpu.parallel import make_mesh as j_make_mesh
from transmf_ad_tpu.parallel import param_shardings as j_param_shardings
from transmf_ad_tpu.parallel import shard_state as j_shard_state
from transmf_ad_tpu.train import build_optimizer as j_build_optimizer
from transmf_ad_tpu.train import create_state as j_create_state
from transmf_ad_tpu.train import make_train_step as j_make_train_step
from transmf_ad_tpu.utils.torch_import import map_state_dict as j_map
from transmf_ad_tpu_torch.models import build_model
from transmf_ad_tpu_torch.parallel import param_shardings
from transmf_ad_tpu_torch.serving import make_inference_fn
from transmf_ad_tpu_torch.train import create_state, make_train_step
from transmf_ad_tpu_torch.utils.weights import state_dict_from_jax

KW = dict(dim=16, depth=1, heads=2, dim_head=8, mlp_dim=32, head_dropout=0.0)
BATCH, SHAPE, MIN_SIZE = 8, (33, 19, 17), 64
LAYOUTS = {"1x2": 2, "2x2": 4}  # data x model -> world
ALL_MODELS = ("single", "cnn", "cnn_ad", "transformer", "transformer_res",
              "ad", "advit", "mnet")
# the volume the parameters of ADVIT and Mnet depend on (the reference
# drivers' padding); the sNet models' do not depend on it
FULL_SHAPES = {"advit": (128, 128, 79), "mnet": (91, 109, 91)}
# (name, keywords, volume) of the "tp_grads" job
ZOO = (("single", dict(dim=16), (33, 19, 17)),
       ("cnn_ad", dict(dim=16), (33, 19, 17)),
       ("transformer", dict(KW), (33, 19, 17)),
       ("advit", dict(input_shape=(32, 32, 79)), (32, 32, 79)),
       ("mnet", dict(input_shape=(25, 31, 25), spatial_kernel=3,
                     spatial_pool=2), (25, 31, 25)),
       ("ad", dict(KW, remat=True), (33, 19, 17)))
RESUME_CFG = dict(model="ad", dim=16, depth=1, heads=2, epochs=1,
                  optimizer="SGD", lr=0.01, aug=False, progress=False,
                  device_cache="off", mask_bn=False, seed=3)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ----- the rule -----

@pytest.fixture(scope="module")
def jax_trees():
    """{model: (JAX parameter tree of shapes, the port model)} at full
    width."""
    out = {}
    for name in ALL_MODELS:
        shape = FULL_SHAPES.get(name, (16, 16, 16))
        x = jax.ShapeDtypeStruct((1, *shape, 1), jnp.float32)
        xs = (x,) if name == "single" else (x, x)
        tree = jax.eval_shape(j_build_model(name, use_pallas=False).init,
                              jax.random.key(0), *xs)["params"]
        out[name] = tree, build_model(name, input_shape=shape)
    return out


@pytest.mark.parametrize("mp", [2, 4])
@pytest.mark.parametrize("name", ALL_MODELS)
def test_rule_names_what_jax_shards(name, mp, jax_trees):
    tree, port = jax_trees[name]
    sd = port.state_dict()
    keys = list(sd)
    ids = {k: torch.full(v.shape, float(i)) for i, (k, v) in
           enumerate(sd.items())}
    mapped = j_map(ids, name)[0]
    assert (jax.tree_util.tree_structure(mapped)
            == jax.tree_util.tree_structure(tree))
    for a, b in zip(jax.tree_util.tree_leaves(mapped),
                    jax.tree_util.tree_leaves(tree)):
        assert a.shape == b.shape
    shardings = j_param_shardings(mapped, j_make_mesh({"data": 8 // mp,
                                                       "model": mp}))
    by_port = {}
    for leaf, s in zip(jax.tree_util.tree_leaves(mapped),
                       jax.tree_util.tree_leaves(shardings)):
        by_port.setdefault(keys[int(leaf.flat[0])], set()).add(
            "model" in s.spec)
    # a fused port tensor (ADVIT's to_qkv) is sharded where all its JAX
    # leaves (to_q, to_kv) are, and they agree
    assert all(len(v) == 1 for v in by_port.values()), by_port
    want = sorted(k for k, v in by_port.items() if True in v)
    got = param_shardings(port, mp)
    assert sorted(got) == want
    assert len(got) > 0


# ----- the steps -----

def _batch():
    rng = np.random.default_rng(3)
    return {"MRI": rng.standard_normal((BATCH, *SHAPE)).astype(np.float32),
            "PET": rng.standard_normal((BATCH, *SHAPE)).astype(np.float32),
            "label": (np.arange(BATCH) % 2).astype(np.int32)}


def jax_variables(name, kw):
    """(the JAX model `name` (Pallas on) with BatchNorm synced over 'data',
    its randomised variables)."""
    x = jnp.zeros((1, 16, 16, 16, 1), jnp.float32)
    v = jax.jit(j_build_model(name, use_pallas=False, **kw).init)(
        jax.random.key(2), x, x)
    model = j_build_model(name, use_pallas=True, axis_name="data", **kw)
    return model, randomize_bn(v, seed=4)


def port_sd(v, name):
    return {k: torch.from_numpy(np.asarray(t))
            for k, t in state_dict_from_jax(v, name).items()}


def jax_mesh_step(model, v, name, batch, adversarial):
    """The JAX package's step on a data-2 x model-2 CPU mesh (its shard_map
    over 'data', the weights placed by its rule): (aux, port state_dict
    after it)."""
    mesh = j_make_mesh({"data": 2, "model": 2})
    tx = j_build_optimizer("SGD", 1.0, milestones=())[0]
    x = jnp.zeros((1, 16, 16, 16, 1), jnp.float32)
    state = j_shard_state(j_create_state(model, tx, [x, x],
                                         jax.random.key(0)).replace(
        params=v["params"], batch_stats=v["batch_stats"]), mesh)
    step = j_make_train_step(donate=False, mesh=mesh,
                             adversarial=adversarial)
    new, aux = step(state, {k: jax.device_put(a, batch_sharding(mesh))
                            for k, a in batch.items()}, jax.random.key(1))
    return ({k: np.asarray(a) for k, a in aux.items()},
            port_sd({"params": new.params, "batch_stats": new.batch_stats},
                    name))


def port_step(name, kw, before, batch, adversarial):
    """The port's one-process step on the global batch: (aux, state)."""
    model = build_model(name, **kw)
    model.load_state_dict(before)
    aux = make_train_step(adversarial=adversarial)(
        create_state(model, "cpu", name="SGD", lr=1.0, milestones=()),
        batch)
    return aux, model.state_dict()


def unit_close(got, ref, rel, what, allow=0.0):
    """max |got - ref| <= rel * max(1, max |ref|) + allow."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    tol = rel * max(1.0, float(np.abs(ref).max())) + allow
    err = float(np.abs(got - ref).max())
    if allow:
        print(f"{what}: error {err:.3e}, tolerance {tol:.3e} ({allow:.3e} "
              "of it allowed)")
    assert err <= tol, f"{what}: {err} > {tol} ({allow} of it allowed)"


def rows(runs, layout, key):
    """A per-sample output, every data index's rows in order (rank d * 2
    holds data index d's)."""
    world = LAYOUTS[layout]
    return np.concatenate([runs[layout, r]["aux"][key].numpy()
                           for r in range(0, world, 2)])


def hold_step(got_aux, got_rows, got_after, ref_aux, ref_after, before,
              rel, per_sample=("logits", "d_mri", "d_pet"), allow=None):
    """Losses and per-sample outputs within `rel` (absolute and relative),
    every update and running statistic within `rel` of max(1, its
    magnitude), plus `allow[name]` where given."""
    allow = allow or {}
    for k in ("loss", "ce_loss", "ad_loss"):
        np.testing.assert_allclose(np.asarray(got_aux[k]),
                                   np.asarray(ref_aux[k]), rtol=rel,
                                   atol=rel, err_msg=k)
    for k in per_sample:
        np.testing.assert_allclose(got_rows(k), np.asarray(ref_aux[k]),
                                   rtol=rel, atol=rel, err_msg=k)
    assert set(got_after) == set(ref_after)
    for k in ref_after:
        if "running" in k:
            unit_close(got_after[k], ref_after[k], rel, k)
        else:
            unit_close(got_after[k] - before[k], ref_after[k] - before[k],
                       rel, k, allow.get(k, 0.0))


def check_ranks(runs, layout, kw):
    """Every rank's whole state bit-identical; each rank's rows of a
    sharded weight its rows of the whole; the convs, the dense layers and
    the heads sharded (attention on heads / 2 heads)."""
    from transmf_ad_tpu_torch.parallel import ModelAxis, Shard
    from transmf_ad_tpu_torch.parallel.mesh import _shard_dim

    world = LAYOUTS[layout]
    first = runs[layout, 0]
    for r in range(1, world):
        other = runs[layout, r]
        assert set(other["after"]) == set(first["after"])
        for k, t in first["after"].items():
            assert torch.equal(other["after"][k], t), (r, k)
        assert torch.equal(other["aux"]["loss"], first["aux"]["loss"])
    names = first["names"]
    assert any(".conv1.0." in n for n in names)  # the stem
    assert any(".fn.to_kv." in n for n in names)
    assert any(n.startswith("fc_cls.") for n in names)
    model = build_model("ad" if "D.0.weight" in first["after"]
                        else "transformer_res", **kw)
    for r in range(world):
        res = runs[layout, r]
        assert res["heads"] and set(res["heads"]) == {kw["heads"] // 2}
        for n, local in res["local"].items():
            p = model.get_parameter(n)
            module = model.get_submodule(n.rpartition(".")[0])
            dim = _shard_dim(module, n.rpartition(".")[2])
            blocks = getattr(module, "shard_blocks", 1)
            shard = Shard(ModelAxis(None, 2, r % 2), dim % p.ndim,
                          p.shape[dim], blocks)
            assert torch.equal(local, shard.rows(res["after"][n])), (r, n)


@pytest.fixture(scope="module")
def jax_ad():
    return jax_variables("ad", KW)


@pytest.fixture(scope="module")
def resume_mp1(adni_root, tmp_path_factory):
    """A single-process one-epoch fit writing `latest.pt` (for a resume at
    model_parallel 2), and the same run resumed one epoch further: (the
    file, the whole state_dict after the resumed epoch)."""
    from transmf_ad_tpu_torch.train.trainer import Trainer, TrainerConfig

    d = tmp_path_factory.mktemp("mp1")
    cfg = TrainerConfig(**RESUME_CFG, save_dir=str(d), device="cpu",
                        save_latest_every=1)
    Trainer(cfg).fit(*_loaders(adni_root))
    path = str(tmp_path_factory.mktemp("mp1_file") / "latest.pt")
    shutil.copy(d / "latest.pt", path)
    resumed = Trainer(TrainerConfig(**dict(RESUME_CFG, epochs=2),
                                    save_dir=str(d), device="cpu",
                                    resume=True, save_latest_every=1))
    resumed.fit(*_loaders(adni_root))
    return path, resumed.state.model.state_dict()


RESUME_SPLIT = dict(train=[0, 1, 2, 3], val=[4, 5], batch_size=4, seed=5)


def _loaders(root):
    from transmf_ad_tpu_torch.data import ADNI, Loader, VolumeSource

    source = VolumeSource(ADNI(root, "ADNI.csv", "ADCN").data_dict,
                          dtype=np.float32)
    b, s = RESUME_SPLIT["batch_size"], RESUME_SPLIT["seed"]
    return (Loader(source, RESUME_SPLIT["train"], b, shuffle=True, seed=s),
            Loader(source, RESUME_SPLIT["val"], b))


@pytest.fixture(scope="module")
def started(jax_ad, resume_mp1, adni_root, tmp_path_factory):
    """The ranks of both layouts, started; they run while JAX compiles."""
    _, v = jax_ad
    d = tmp_path_factory.mktemp("tp")
    torch.save(port_sd(v, "ad"), d / "w.pt")
    np.savez(d / "batch.npz", **_batch())
    common = {"model": "ad", "model_kw": KW, "weights": str(d / "w.pt"),
              "batch": str(d / "batch.npz"), "mp": 2, "min_size": MIN_SIZE}
    fit = {"kind": "tp_resume", "mp": 2, "root": adni_root,
           "cfg": RESUME_CFG, **{k: RESUME_SPLIT[k] for k in
                                 ("train", "val", "seed")},
           "batch_size": RESUME_SPLIT["batch_size"]}
    two = Ranks([{"name": "1x2", "kind": "tp_step", "adversarial": True,
                  **common},
                 {"name": "serve", "kind": "tp_serve", **common},
                 {"name": "zoo", "kind": "tp_grads", "mp": 2, "min_size": 16,
                  "batch": 8, "remat_min_mb": 0,
                  "models": [list(z) for z in ZOO]},
                 {"name": "resume", **fit, "save_dir": str(d / "ck2")},
                 {"name": "resume_mp1", **fit, "save_dir": str(d / "ck1"),
                  "resume_from": resume_mp1[0]}],
                str(d / "out2"), world=2, timeout=170)
    four = Ranks([{"name": "2x2", "kind": "tp_step", "adversarial": True,
                   **common}], str(d / "out4"), world=4, timeout=170)
    yield two, four, d
    for ranks in (two, four):
        for p in ranks.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def jax_step(jax_ad, started):
    model, v = jax_ad
    return jax_mesh_step(model, v, "ad", _batch(), adversarial=True)


@pytest.fixture(scope="module")
def runs(started, jax_step):
    two, four, _ = started
    out = {}
    for ranks, layout in ((two, "1x2"), (four, "2x2")):
        for (job, r), res in ranks.wait().items():
            out[layout if job == layout else job, r] = res
    return out


@pytest.fixture(scope="module")
def single(jax_ad):
    return port_step("ad", KW, port_sd(jax_ad[1], "ad"), _batch(), True)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_step_matches_single_process(layout, runs, single, jax_ad):
    aux, after = single
    hold_step(runs[layout, 0]["aux"], lambda k: rows(runs, layout, k),
              runs[layout, 0]["after"],
              {k: t.numpy() for k, t in aux.items()}, after,
              port_sd(jax_ad[1], "ad"), 1e-4)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_step_matches_jax(layout, runs, jax_step, jax_ad):
    aux, after = jax_step
    hold_step(runs[layout, 0]["aux"], lambda k: rows(runs, layout, k),
              runs[layout, 0]["after"], aux, after,
              port_sd(jax_ad[1], "ad"), 1e-4)
    for k in ("label", "mask"):
        np.testing.assert_array_equal(rows(runs, layout, k), aux[k])


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_ranks_bit_identical_and_sharded(layout, runs):
    check_ranks(runs, layout, KW)


@pytest.mark.parametrize("name", [z[0] + (" remat" if z[1].get("remat")
                                          else "") for z in ZOO])
def test_other_models_and_remat_match_one_process(name, runs, monkeypatch):
    from tests._torch_dp_worker import grads_case

    monkeypatch.setenv("TRANSMF_REMAT_MIN_MB", "0")
    case = next(z for z in ZOO if name.startswith(z[0]))
    logits, grads = grads_case(*case, batch=8)
    for r in range(2):
        got_logits, got = runs["zoo", r][case[0]]
        unit_close(got_logits, logits, 1e-4, f"{name} logits")
        assert set(got) == set(grads)
        for k, g in grads.items():
            unit_close(got[k], g, 1e-4, f"{name} {k}")


def test_sharded_serving_matches_single_process(runs, jax_ad):
    model = build_model("ad", **KW)
    model.load_state_dict(port_sd(jax_ad[1], "ad"))
    b = _batch()
    want = make_inference_fn(model, "cpu")(b["MRI"], b["PET"])
    got = [runs["serve", r]["probs"] for r in range(2)]
    names = runs["serve", 0]["names"]  # JAX's rule at its 2,048 elements
    assert "mri_cnn.conv4.0.weight" in names and "D.0.weight" in names
    assert torch.equal(got[0], got[1])
    np.testing.assert_allclose(got[0].numpy(), want.numpy(), atol=1e-4,
                               rtol=1e-4)


def test_latest_resumes_across_layouts(runs, resume_mp1, started,
                                       adni_root, tmp_path):
    """model_parallel 2 -> 1: the single process resumes the ranks' file;
    1 -> 2: the ranks resumed the single process's. Each against the run
    that kept its layout, within 1e-5."""
    from transmf_ad_tpu_torch.train.trainer import Trainer, TrainerConfig

    _, _, d = started
    shutil.copy(os.path.join(d, "out2", "latest_mp2.pt"),
                tmp_path / "latest.pt")
    resumed = Trainer(TrainerConfig(**dict(RESUME_CFG, epochs=2),
                                    save_dir=str(tmp_path), device="cpu",
                                    resume=True))
    resumed.fit(*_loaders(adni_root))
    assert resumed.state.step == runs["resume", 0]["step"] == 2
    for got, ref in ((resumed.state.model.state_dict(),
                      runs["resume", 0]["after"]),
                     (runs["resume_mp1", 0]["after"], resume_mp1[1])):
        assert set(got) == set(ref)
        for k in ref:
            unit_close(got[k], ref[k], 1e-5, k)
    log = open(os.path.join(d, "ck2", "log.txt")).read()
    assert "WARNING: model_parallel=2 at dim=16" in log


def test_mesh_must_cover_the_world(monkeypatch):
    from transmf_ad_tpu_torch.parallel import mesh as mesh_mod

    with pytest.raises(ValueError, match="needs 2 processes, have 1"):
        mesh_mod.make_mesh({"data": 1, "model": 2})
    monkeypatch.setattr(mesh_mod.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(mesh_mod.dist, "get_world_size", lambda *a: 3)
    with pytest.raises(ValueError, match="covers 2 of 3"):
        mesh_mod.make_mesh({"data": 1, "model": 2})
    with pytest.raises(ValueError, match="covers 2 of 3"):
        mesh_mod.make_mesh({"data": -1, "model": 2})
    with pytest.raises(ValueError, match="axes are 'data' and 'model'"):
        mesh_mod.make_mesh({"data": 1, "tensor": 3})


def test_world_that_model_parallel_does_not_divide(monkeypatch, tmp_path):
    from transmf_ad_tpu_torch.train import trainer as trainer_mod

    monkeypatch.setattr(trainer_mod, "process_count", lambda: 3)
    with pytest.raises(ValueError, match="does not divide the 3"):
        trainer_mod.Trainer(trainer_mod.TrainerConfig(
            model_parallel=2, device="cpu", save_dir=str(tmp_path)))
    with pytest.raises(ValueError, match="at least 1"):
        trainer_mod.TrainerConfig(model_parallel=0)
