"""The port's reference-checkpoint importer against the JAX package's.

For each of the 8 `SUPPORTED_MODELS` a reference-format `.pt` file: the
port model's state_dict (`init_weights`, BatchNorm affines and running
statistics randomised) under 'net_model', plus what a reference file
carries and both importers skip: every BatchNorm's `num_batches_tracked`,
ADVIT's `vit_*.mlp_head.*` and Mnet's dead spatial `conv2.*` / `conv3.*` stacks. The JAX package's
`import_torch_checkpoint` and the port's read it; the eval forwards of
the two packages (JAX's plain path) agree within 1e-4, and the port's
model holds the file's tensors exactly. A file of another width or depth
raises the same `ValueError` in both. The Mnet file goes through
`Trainer.load_checkpoint` and `cli/evaluate.py` (at the parity tests'
geometry: (25, 31, 25), spatial kernel 3, pool 2), which score it as they
score the port's own file of the same weights.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import SMALL
from transmf_ad_tpu.models import build_model as j_build_model
from transmf_ad_tpu.utils import torch_import as j_import
from transmf_ad_tpu_torch.models import build_model
from transmf_ad_tpu_torch.utils import torch_import
from transmf_ad_tpu_torch.utils.weights import init_weights

MNET = dict(input_shape=(25, 31, 25), spatial_kernel=3, spatial_pool=2)
# per model: (port / JAX keywords, the volume)
CASES = {
    "single": (dict(dim=16), (2, 35, 37, 33)),
    "cnn": (dict(dim=16), (2, 35, 37, 33)),
    "cnn_ad": (dict(dim=16), (2, 35, 37, 33)),
    "transformer": (dict(SMALL), (2, 35, 37, 33)),
    "transformer_res": (dict(SMALL), (2, 35, 37, 33)),
    "ad": (dict(SMALL), (2, 35, 37, 33)),
    "advit": (dict(input_shape=(32, 32, 79)), (2, 32, 32, 79)),
    "mnet": (MNET, (2, 25, 31, 25)),
}


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_kw(name, kw):
    """The JAX models take no `input_shape` (they infer it) and Mnet's
    spatial geometry under its own keywords."""
    kw = {k: v for k, v in kw.items() if k != "input_shape"}
    if name == "advit":
        return {}
    return kw


def _inputs(name, shape, seed=0):
    rng = np.random.default_rng(seed)
    n = 1 if name == "single" else 2
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def reference_file(sd, name, path):
    """`sd` as a reference run saves it: under 'net_model', with every
    BatchNorm's counter and the keys the forward never reads."""
    ref = dict(sd)
    for k in sd:
        if k.endswith(".running_mean"):
            ref[k[:-len("running_mean")] + "num_batches_tracked"] = \
                torch.tensor(7)
    if name == "advit":
        for mod in ("mri", "pet"):
            ref[f"vit_{mod}.mlp_head.0.weight"] = torch.ones(192)
            ref[f"vit_{mod}.mlp_head.0.bias"] = torch.ones(192)
            ref[f"vit_{mod}.mlp_head.1.weight"] = torch.ones(2, 192)
            ref[f"vit_{mod}.mlp_head.1.bias"] = torch.ones(2)
    if name == "mnet":
        for mod in ("mri", "pet"):
            for view in ("axial", "col", "sag"):
                p = f"{mod}.spatial_cnn_{view}"
                for stack in ("conv2", "conv3"):
                    ref[f"{p}.{stack}.0.weight"] = torch.ones(16, 8, 3, 3, 1)
                    ref[f"{p}.{stack}.0.bias"] = torch.ones(16)
                    for n in ("weight", "bias", "running_mean",
                              "running_var"):
                        ref[f"{p}.{stack}.1.{n}"] = torch.ones(16)
                    ref[f"{p}.{stack}.1.num_batches_tracked"] = \
                        torch.tensor(3)
    torch.save({"net_model": ref, "epoch": 5}, path)
    return path


def _weights(name, kw, seed=2):
    """A port state_dict: `init_weights`, then every BatchNorm's affine and
    running statistics drawn, so that eval BatchNorm is far from the
    identity."""
    port = build_model(name, **kw)
    init_weights(port, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    sd = port.state_dict()
    for k, t in sd.items():
        if k.endswith("running_var"):
            t.copy_(0.5 + 1.5 * torch.rand(t.shape, generator=g))
            p = k[:-len("running_var")]
            sd[p + "running_mean"].normal_(0.0, 0.2, generator=g)
            sd[p + "weight"].uniform_(0.5, 1.5, generator=g)
            sd[p + "bias"].normal_(0.0, 0.1, generator=g)
    return {k: t.clone() for k, t in sd.items()}


def _template(name, kw, shape):
    """JAX's variables of the model, shapes only."""
    xs = [jax.ShapeDtypeStruct((1, *shape[1:], 1), jnp.float32)] * (
        1 if name == "single" else 2)
    jmodel = j_build_model(name, use_pallas=False, **_jax_kw(name, kw))
    return jmodel, jax.eval_shape(jmodel.init, jax.random.key(0), *xs)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """{model: (reference file, the port state_dict in it, JAX model,
    JAX's variables as shapes)}."""
    d = tmp_path_factory.mktemp("ref")
    out = {}
    for name, (kw, shape) in CASES.items():
        sd = _weights(name, kw)
        out[name] = (reference_file(sd, name, d / f"{name}.pt"), sd,
                     *_template(name, kw, shape))
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_reference_file_loads_as_in_jax(name, files):
    path, sd, jmodel, v = files[name]
    kw, shape = CASES[name]
    port = build_model(name, **kw)
    got = torch_import.import_torch_checkpoint(str(path), name, port)
    assert set(got) == set(port.state_dict())
    port.load_state_dict(got, strict=True)
    for k, t in port.state_dict().items():
        assert torch.equal(t, sd[k]), k
    jvars = j_import.import_torch_checkpoint(str(path), name, v)
    xs = _inputs(name, shape)
    want = jax.jit(lambda var, *a: jmodel.apply(var, *a, train=False))(
        jvars, *(jnp.asarray(x)[..., None] for x in xs))
    with torch.no_grad():
        out = port(*(torch.from_numpy(x)[..., None] for x in xs),
                   train=False)
    for a, b in zip(*(o if isinstance(o, tuple) else (o,)
                      for o in (out, want))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=1e-4)


def test_unknown_model_raises_in_both():
    for fn in (torch_import.map_state_dict, j_import.map_state_dict):
        with pytest.raises(ValueError, match="torch import supports"):
            fn({}, "vit")
    assert torch_import.SUPPORTED_MODELS == j_import.SUPPORTED_MODELS


@pytest.mark.parametrize("wrong", ["dim", "depth"])
def test_mismatch_raises_in_both(wrong, files):
    """The ModelAd file (dim 16, depth 2) into a dim-8 model: "shape
    mismatch at ..."; into a depth-1 model: "maps N tensors but the model
    has M (dim/depth mismatch?)", in both packages."""
    path, _, _, _ = files["ad"]
    kw = dict(SMALL, **({"dim": 8, "dim_head": 4} if wrong == "dim"
                        else {"depth": 1}))
    match = ("shape mismatch at" if wrong == "dim" else
             r"maps \d+ tensors but the model has \d+ \(dim/depth mismatch")
    _, jv = _template("ad", kw, (1, 16, 16, 16))
    with pytest.raises(ValueError, match=match):
        j_import.import_torch_checkpoint(str(path), "ad", jv)
    with pytest.raises(ValueError, match=match):
        torch_import.import_torch_checkpoint(str(path), "ad",
                                             build_model("ad", **kw))


def test_mnet_file_through_trainer_and_evaluate_cli(files, adni_root,
                                                    tmp_path, monkeypatch):
    """`Trainer.load_checkpoint` takes the reference Mnet file (its dead
    spatial stacks and counters skipped) to the file's weights, and
    `cli/evaluate.py --model mnet` scores it as it scores the port's own
    file of the same weights."""
    from transmf_ad_tpu_torch.cli import evaluate
    from transmf_ad_tpu_torch.train import kfold
    from transmf_ad_tpu_torch.train.trainer import Trainer, TrainerConfig

    path, sd, _, _ = files["mnet"]
    trainer = Trainer(TrainerConfig(
        model="mnet", device="cpu", save_dir=str(tmp_path / "t"),
        model_kwargs=dict(spatial_kernel=3, spatial_pool=2),
        progress=False))
    vol = np.zeros((2, *MNET["input_shape"]), np.float32)
    trainer.init_state({"MRI": vol, "PET": vol,
                        "label": np.zeros(2, np.int32)}, 1)
    trainer.load_checkpoint(str(path))
    for k, t in trainer.state.model.state_dict().items():
        assert torch.equal(t, sd[k]), k

    own = tmp_path / "own.pt"
    torch.save(sd, own)
    real_spec, real_cfg = kfold._variant_spec, kfold._make_trainer_cfg
    monkeypatch.setattr(evaluate, "_variant_spec", lambda v, o: dict(
        real_spec(v, o), pad_to=MNET["input_shape"]))
    monkeypatch.setattr(evaluate, "_make_trainer_cfg", lambda *a: dataclasses
                        .replace(real_cfg(*a), model_kwargs=dict(
                            spatial_kernel=3, spatial_pool=2)))
    flags = ["--model", "mnet", "--task", "ADCN", "--dataroot", adni_root,
             "--device", "cpu", "--batch_size", "4", "--checkpoints_dir",
             str(tmp_path / "ck")]
    got = evaluate.main(["--checkpoint", str(path), *flags])
    want = evaluate.main(["--checkpoint", str(own), *flags])
    assert float(got["confusion"].sum()) == 8  # every AD and CN pair
    for k in ("loss", "accuracy", "sen", "spe", "auc"):
        assert got[k] == want[k] or (np.isnan(got[k]) and np.isnan(want[k]))
