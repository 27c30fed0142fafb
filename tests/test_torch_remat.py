"""Per-block remat of the port (`SNet(remat=True)`) on the CPU.

The rule (`nn/blocks.py::_remat_worth_it`) picks the blocks whose
intermediates reach TRANSMF_REMAT_MIN_MB MiB; the port's choice at the
models' shapes equals the JAX package's, read from a shape-only trace of
its SNet (no forward runs): at batch 8, 91x109x91 the stem block alone,
at batch 6, 182x218x182 blocks 0, 1, 2 and 4 (block 4, 64 -> 128 channels
at 45x54x45, has 320 MiB of intermediates; block 3 has 160).

Then one SGD (lr 1) step of a small ModelAd with TRANSMF_REMAT_MIN_MB at 0
in both packages, so that every block recomputes at the test's volumes, in
four forms from the same weights: the port with and without remat, and the
JAX package (its Pallas path in interpret mode, as tests/test_torch_train.py
runs it) with `remat=True` and without. The port's two steps agree bit for
bit (losses, every gradient and running statistic: the recompute is the
same arithmetic, and the running statistics move once); the port's remat
step agrees with JAX's under the rule of tests/test_torch_train.py: losses
within 1e-4, every gradient and running statistic within 1e-4 of max(1,
its magnitude) (JAX's plain XLA path misses that by up to 1.8x on the PET
encoder's second block, with and without remat, while the Pallas path
stays within 0.9 of it); JAX's two steps agree with each other within
1e-4. A planted fault, the recompute moving the running statistics a
second time, must break the bit-for-bit agreement.
"""

import contextlib
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import randomize_bn
from transmf_ad_tpu.models import build_model as j_build_model
from transmf_ad_tpu.nn import blocks as j_blocks
from transmf_ad_tpu.train import build_optimizer as j_build_optimizer
from transmf_ad_tpu.train import create_state as j_create_state
from transmf_ad_tpu.train import make_train_step as j_make_train_step
from transmf_ad_tpu_torch.models import build_model
from transmf_ad_tpu_torch.nn import batchnorm
from transmf_ad_tpu_torch.nn import blocks
from transmf_ad_tpu_torch.train import create_state, make_train_step
from transmf_ad_tpu_torch.utils.weights import state_dict_from_jax

KW = dict(dim=16, depth=1, heads=2, dim_head=8, mlp_dim=32, head_dropout=0.0)
BATCH, SHAPE, SEED = 4, (33, 19, 17), 2  # tests/test_torch_train.py's
SGD = dict(name="SGD", lr=1.0, milestones=())


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


@pytest.mark.parametrize("shape,want", [
    ((8, 91, 109, 91, 1), [0]),
    ((6, 182, 218, 182, 1), [0, 1, 2, 4]),
    ((1, 182, 218, 182, 1), [0]),
    ((2, 91, 109, 91, 1), []),
], ids=["s8", "f6", "f1", "s2"])
def test_remat_blocks_equal_jax(shape, want, monkeypatch):
    monkeypatch.delenv("TRANSMF_REMAT_MIN_MB", raising=False)
    port = build_model("ad").mri_cnn
    assert port.remat_blocks(shape) == want
    seen = []
    real = j_blocks._remat_worth_it

    def spy(x_shape, feats, itemsize=2):
        seen.append(real(x_shape, feats, itemsize))
        return seen[-1]

    monkeypatch.setattr(j_blocks, "_remat_worth_it", spy)
    snet = j_blocks.SNet(dim=128, use_pallas=False, remat=True)
    jax.eval_shape(snet.init, jax.random.key(0),
                   jax.ShapeDtypeStruct(shape, jnp.bfloat16))
    assert [i for i, hit in enumerate(seen) if hit] == want


def test_remat_rule_sizes():
    """2 x prod(shape[:-1]) x features x 2 bytes against 300 MiB, whatever
    the dtype; the environment variable moves the threshold."""
    assert blocks._remat_worth_it((6, 45, 54, 45, 64), 128)  # 320 MiB
    assert not blocks._remat_worth_it((6, 45, 54, 45, 64), 64)  # 160 MiB
    assert blocks._remat_worth_it((1, 2, 2, 2, 1), 1) == (
        j_blocks._remat_worth_it((1, 2, 2, 2, 1), 1))


def _batch():
    rng = np.random.default_rng(SEED)
    return {"MRI": rng.standard_normal((BATCH, *SHAPE)).astype(np.float32),
            "PET": rng.standard_normal((BATCH, *SHAPE)).astype(np.float32),
            "label": (np.arange(BATCH) % 2).astype(np.int32)}


@contextlib.contextmanager
def _remat_everywhere():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TRANSMF_REMAT_MIN_MB", "0")
        yield


@pytest.fixture(scope="module")
def weights():
    x = jnp.zeros((1, 16, 16, 16, 1), jnp.float32)
    v = jax.jit(j_build_model("ad", use_pallas=False, **KW).init)(
        jax.random.key(2), x, x)
    return randomize_bn(v, seed=4)


def _port_step(v, remat):
    """One port SGD step: (losses, {name: gradient or running statistic},
    the number of recomputed blocks)."""
    model = build_model("ad", remat=remat, **KW)
    model.load_state_dict({k: torch.from_numpy(np.asarray(t)) for k, t in
                           state_dict_from_jax(v, "ad").items()})
    before = copy.deepcopy(model.state_dict())
    recomputed = []
    real = batchnorm.recomputing

    def counting(group):
        recomputed.append(group)
        return real(group)

    with _remat_everywhere(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(batchnorm, "recomputing", counting)
        aux = make_train_step()(create_state(model, "cpu", **SGD), _batch())
    out = {k: (t if "running" in k else before[k] - t)  # lr 1: the gradient
           for k, t in model.state_dict().items()}
    return ({k: aux[k] for k in ("loss", "ce_loss", "ad_loss")}, out,
            len(recomputed))


@pytest.fixture(scope="module")
def port_steps(weights):
    return {remat: _port_step(weights, remat) for remat in (False, True)}


@pytest.fixture(scope="module")
def jax_steps(weights):
    """{remat: (losses, {name: gradient or running statistic})}, JAX's
    Pallas path."""
    out = {}
    x = jnp.zeros((1, 16, 16, 16, 1), jnp.float32)
    tx = j_build_optimizer(**SGD)[0]
    before = state_dict_from_jax(weights, "ad")
    with _remat_everywhere():
        for remat in (False, True):
            model = j_build_model("ad", use_pallas=True, remat=remat, **KW)
            state = j_create_state(model, tx, [x, x], jax.random.key(0)
                                   ).replace(params=weights["params"],
                                             batch_stats=weights[
                                                 "batch_stats"])
            new, aux = j_make_train_step(donate=False)(
                state, _batch(), jax.random.key(1))
            after = state_dict_from_jax({"params": new.params,
                                         "batch_stats": new.batch_stats},
                                        "ad")
            out[remat] = ({k: np.asarray(aux[k]) for k in
                           ("loss", "ce_loss", "ad_loss")},
                          {k: (np.asarray(t) if "running" in k
                               else np.asarray(before[k]) - np.asarray(t))
                           for k, t in after.items()})
    return out


def test_port_remat_step_bit_identical(port_steps):
    (l0, g0, n0), (l1, g1, n1) = port_steps[False], port_steps[True]
    assert n0 == 0 and n1 == 14  # every block of both encoders
    for k in l0:
        assert torch.equal(l0[k], l1[k]), k
    assert g0.keys() == g1.keys()
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


def _unit_close(got, ref, what):
    """max |got - ref| <= 1e-4 * max(1, max |ref|)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    tol = 1e-4 * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= tol, f"{what}: {err} > {tol}"


def test_port_remat_step_matches_jax_remat(port_steps, jax_steps):
    losses, grads, _ = port_steps[True]
    ref_losses, ref_grads = jax_steps[True]
    for k in ref_losses:
        np.testing.assert_allclose(losses[k].numpy(), ref_losses[k],
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    assert grads.keys() == ref_grads.keys()
    for k in ref_grads:
        _unit_close(grads[k].numpy(), ref_grads[k], k)


def test_jax_remat_steps_agree(jax_steps):
    for k, ref in jax_steps[False][1].items():
        _unit_close(jax_steps[True][1][k], ref, k)
    for k, ref in jax_steps[False][0].items():
        np.testing.assert_allclose(jax_steps[True][0][k], ref, rtol=1e-5,
                                   err_msg=k)


def test_double_running_update_is_caught(weights, port_steps, monkeypatch):
    """The planted fault: the recompute updates the running statistics a
    second time. The comparison of the remat step with the plain one then
    fails on the running statistics (and only there)."""
    monkeypatch.setattr(batchnorm, "recomputing", batchnorm.synced)
    _, faulty, _ = _port_step(weights, True)
    _, plain, _ = port_steps[False]
    moved = [k for k in plain if not torch.equal(faulty[k], plain[k])]
    assert moved and all("running" in k for k in moved), moved
    with pytest.raises(AssertionError):
        for k in plain:
            assert torch.equal(faulty[k], plain[k]), k
