"""Port sharded serving against the JAX package's, case for case with the
sharded cases of tests/test_serving.py, float32 on the CPU.

`make_sharded_inference_fn` runs on two Gloo ranks
(`tests/_torch_dp_worker.py`, job "serve"), held to one port process bit
for bit and to the JAX package's `make_sharded_inference_fn` on a data-2
CPU mesh within the f32 rule (`tests/_torch_parity.py::close`, 1e-4).
The ranks start before the JAX side compiles, so the two overlap. Also: a
loaded artifact needs no model code.
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_dp_worker import ROOT, Ranks
from tests._torch_parity import close
from tests.test_torch_serving_export import (PAIR, SHAPE, _equal, _states,
                                             _vols)
from transmf_ad_tpu import serving as j_serving
from transmf_ad_tpu.parallel import make_mesh
from transmf_ad_tpu_torch.serving import (export_inference,
                                          make_inference_fn,
                                          make_sharded_inference_fn)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the tier runs six test workers at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def states():
    return _states()


def test_sharded_matches_single_process_and_jax(states, tmp_path, rng):
    """Two Gloo ranks: every rank gets the same global probabilities, bit
    for bit; they equal one port process and the JAX package's sharded
    forward on a data-2 mesh; a batch of 3 raises in both packages."""
    state, port = states
    mri, pet = _vols(rng, 4)
    np.savez(tmp_path / "batch.npz", MRI=mri, PET=pet)
    torch.save(port.state_dict(), tmp_path / "w.pt")
    ranks = Ranks([{"name": "serve", "kind": "serve", "model": "cnn_ad",
                    "model_kw": {"dim": 8}, "weights": str(tmp_path / "w.pt"),
                    "batch": str(tmp_path / "batch.npz")}],
                  str(tmp_path / "out"), world=2, timeout=120)
    mesh = make_mesh({"data": 2})
    j_fn = j_serving.make_sharded_inference_fn(state, PAIR, True, mesh)
    want = j_fn(jnp.asarray(mri), jnp.asarray(pet))
    with pytest.raises(ValueError, match="divisible"):
        j_fn(jnp.asarray(mri[:3]), jnp.asarray(pet[:3]))
    res = ranks.wait()
    got = [res["serve", r]["probs"] for r in range(2)]
    _equal(got[0], got[1])
    _equal(got[0], make_inference_fn(port, "cpu")(mri, pet))
    close(got[0], want)
    for r in range(2):
        assert "does not split over 2 ranks" in res["serve", r]["ragged"]


def test_sharded_without_group_is_make_inference_fn(states, rng):
    _, port = states
    mri, pet = _vols(rng, 3)
    _equal(make_sharded_inference_fn(port, None, "cpu")(mri, pet),
           make_inference_fn(port, "cpu")(mri, pet))


def test_loaded_program_needs_no_model_code(states, tmp_path):
    """A process that imports the serving module alone loads the program
    and serves it without importing `models`."""
    path = export_inference(states[1], PAIR, str(tmp_path / "m.pt2"), SHAPE,
                            device="cpu")
    code = (
        "import sys, numpy as np\n"
        "from transmf_ad_tpu_torch.serving import load_inference\n"
        f"p = load_inference({path!r})(*np.zeros((2, 3, *{SHAPE}),"
        " np.float32))\n"
        "assert p.shape == (3, 2), p.shape\n"
        "bad = [m for m in sys.modules if m.startswith("
        "('transmf_ad_tpu_torch.models', 'transmf_ad_tpu_torch.nn', "
        "'jax', 'transmf_ad_tpu.'))]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)
