"""Port serving artifacts against the JAX package's, case for case with
tests/test_serving.py (its sharded cases: tests/test_torch_serving_sharded.py),
float32 on the CPU.

The JAX model's variables (BatchNorm statistics randomised) go to the port
through `state_dict_from_jax`. The port's `export_inference` writes a
`torch.export` program; `load_inference` serves it. The loaded program is
held to the port's `make_inference_fn` bit for bit, and to the JAX
package's own loaded StableHLO artifact on the same weights within the f32
rule (`tests/_torch_parity.py::close`, 1e-4). Each artifact is exported
once per module (`artifacts`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import close, randomize_bn
from transmf_ad_tpu import serving as j_serving
from transmf_ad_tpu.models import build_model as j_build_model
from transmf_ad_tpu.train.optim import build_optimizer
from transmf_ad_tpu.train.steps import create_state
from transmf_ad_tpu_torch.models import build_model
from transmf_ad_tpu_torch.serving import (export_inference, load_inference,
                                          make_inference_fn)
from transmf_ad_tpu_torch.train import checkpoint as ckpt
from transmf_ad_tpu_torch.utils.weights import state_dict_from_jax

SHAPE = (16, 16, 16)
PAIR = ("MRI", "PET")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the tier runs six test workers at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _states(name="cnn_ad", modalities=PAIR):
    """(JAX state with randomised BatchNorm statistics, the port model on
    the same weights)."""
    tx, _ = build_optimizer("Adam", 1e-3, steps_per_epoch=1)
    x = jnp.zeros((2, *SHAPE, 1), jnp.float32)
    state = create_state(j_build_model(name, dim=8), tx,
                         [x] * len(modalities), jax.random.key(0))
    v = randomize_bn({"params": state.params,
                      "batch_stats": state.batch_stats}, seed=4)
    state = state.replace(**v)
    port = build_model(name, dim=8)
    port.load_state_dict(state_dict_from_jax(v, name), strict=True)
    return state, port


@pytest.fixture(scope="module")
def states():
    return _states()


@pytest.fixture(scope="module")
def artifacts(states, tmp_path_factory):
    """{(package, batch_size): loaded artifact} of the weights: the JAX
    package's StableHLO and the port's `.pt2`, pinned at batch 2 and with a
    symbolic batch (None), each exported and loaded once."""
    state, port = states
    tmp = tmp_path_factory.mktemp("artifacts")
    out = {}
    for b in (2, None):
        path = str(tmp / f"model_{b}.stablehlo")
        j_serving.export_inference(state, PAIR, True, path, SHAPE,
                                   batch_size=b)
        out["jax", b] = j_serving.load_inference(path)
        out["port", b] = load_inference(export_inference(
            port, PAIR, str(tmp / f"model_{b}.pt2"), SHAPE, batch_size=b,
            device="cpu"))
    return out


def _vols(rng, b, n=2):
    return [rng.standard_normal((b, *SHAPE)).astype(np.float32)
            for _ in range(n)]


def _equal(got, want):
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_export_roundtrip(states, artifacts, rng):
    _, port = states
    mri, pet = _vols(rng, 2)
    probs = artifacts["port", 2](mri, pet)
    assert probs.dtype == torch.float32 and probs.shape == (2, 2)
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, atol=1e-6)
    _equal(probs, make_inference_fn(port, "cpu")(mri, pet))
    close(probs, artifacts["jax", 2](mri, pet))


def test_polymorphic_batch(states, artifacts, rng):
    """The default export has a symbolic batch: one program serves any
    batch size, 1 included, each as the live forward does."""
    _, port = states
    fn, j_fn = artifacts["port", None], artifacts["jax", None]
    live = make_inference_fn(port, "cpu")
    for b in (1, 3, 5):
        mri, pet = _vols(rng, b)
        probs = fn(mri, pet)
        assert probs.shape == (b, 2)
        _equal(probs, live(mri, pet))
        close(probs, j_fn(mri, pet))


def test_single_modality_export(tmp_path, rng):
    """The non-adversarial single-modality model exports and serves."""
    state, port = _states("single", ("MRI",))
    path = export_inference(port, ("MRI",), str(tmp_path / "single.pt2"),
                            SHAPE, batch_size=2, device="cpu")
    jpath = str(tmp_path / "single.stablehlo")
    j_serving.export_inference(state, ("MRI",), False, jpath, SHAPE,
                               batch_size=2)
    (x,) = _vols(rng, 2, 1)
    probs = load_inference(path)(x)
    assert probs.shape == (2, 2)
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, atol=1e-6)
    _equal(probs, make_inference_fn(port, "cpu")(x))
    close(probs, j_serving.load_inference(jpath)(x))


def test_pinned_batch_raises_on_another(artifacts, rng):
    """An integer batch_size pins the batch in both packages: another batch
    size raises (the port's program from its input guard)."""
    mri, pet = _vols(rng, 3)
    with pytest.raises((AssertionError, RuntimeError), match="2"):
        artifacts["port", 2](mri, pet)
    with pytest.raises(ValueError):
        artifacts["jax", 2](mri, pet)


def test_artifact_matches_trained_checkpoint(states, artifacts, tmp_path,
                                             rng):
    """Export -> checkpoint save and load -> export again: the same
    probabilities, so the artifact is a function of the saved weights."""
    _, port = states
    ckpt.save_latest(str(tmp_path), {"model": port.state_dict()})
    again = build_model("cnn_ad", dim=8)
    again.load_state_dict(ckpt.load(str(tmp_path / "latest.pt")))
    path = export_inference(again, PAIR, str(tmp_path / "again.pt2"), SHAPE,
                            batch_size=2, device="cpu")
    mri, pet = _vols(rng, 2)
    _equal(load_inference(path)(mri, pet), artifacts["port", 2](mri, pet))
