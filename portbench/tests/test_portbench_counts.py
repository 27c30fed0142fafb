"""The operation counts from shapes against the hand-worked values."""

from __future__ import annotations

import pytest

from portbench import harness, peaks
from portbench.counts import kernels, model


@pytest.fixture
def ad():
    return harness.load_json(harness.HERE / "configs/model_ad.json")


def test_forward_convs_per_pair(ad):
    # the encoders' convs: 62.5 GF a pair at 91x109x91, 517.5 at 182^3-ish
    assert model.forward_per_pair(ad, (91, 109, 91))["conv"] == \
        pytest.approx(62.5e9, rel=1e-3)
    assert model.forward_per_pair(ad, (182, 218, 182))["conv"] == \
        pytest.approx(517.5e9, rel=1e-3)
    stem = 2 * (2 * 1 * 32 * 27 * 182 * 218 * 182)
    assert model.forward_per_pair(ad, (182, 218, 182))["stem"] == stem


def test_train_is_three_forwards_less_the_stems(ad):
    f = model.forward_per_pair(ad, (182, 218, 182))
    assert model.train_per_pair(ad, (182, 218, 182)) == \
        3 * (f["conv"] + f["rest"]) - f["stem"]
    # batch 6: 9.3 TF a step, the fusion and heads about 1% of it
    assert 6 * model.train_per_pair(ad, (182, 218, 182)) == \
        pytest.approx(9.37e12, rel=5e-3)
    assert f["rest"] / f["conv"] < 0.025


def test_joint_context_attention_counts_double_keys(ad):
    res = harness.load_json(harness.HERE / "configs/transformer_res.json")
    n = 11 * 13 * 11
    a = model.forward_per_pair(ad, (182, 218, 182))["rest"]
    r = model.forward_per_pair(res, (182, 218, 182))["rest"]
    # six layers a pair whose keys double (N -> 2N): to_kv's product and
    # the attention's grow by 4 * N * dim * inner and 4 * N^2 * inner;
    # the head reads 2 * dim features instead of 4 * dim, no discriminator
    dim = inner = 128
    want = (6 * (4 * n * dim * inner + 4 * n * n * inner)
            - 2 * 2 * dim * 512 - 2 * 2 * (dim * 128 + 128 * 2))
    assert r - a == want


def test_band_conv_least_time():
    # K8 at (6, 91, 109, 91) 32 -> 64 in bf16: operations bind
    x, w = [6, 91, 109, 91, 32], [3, 3, 3, 32, 64]
    t, kind = kernels.least_time_s("band_conv", [x, w],
                                   ["c10::BFloat16"] * 2)
    ops = 2 * 27 * 6 * 91 * 109 * 91 * 32 * 64
    assert kind == "operations"
    assert t == pytest.approx(ops / peaks.FLOPS["bfloat16"])


def test_pool_least_time_counts_each_byte_once():
    y = [6, 182, 218, 182, 32]
    t, kind = kernels.least_time_s(
        "affine_act_pool", [y, [182 * 32], [182 * 32], [], [], [], []],
        ["c10::BFloat16", "float", "float", "Scalar", "", "Scalar",
         "Scalar"])
    n = 6 * 182 * 218 * 182 * 32
    nbytes = 2 * n + 2 * 4 * 182 * 32 + 2 * (6 * 91 * 109 * 91 * 32)
    assert kind == "bytes"
    assert t == pytest.approx(nbytes / peaks.HBM_BYTES_PER_S, rel=1e-6)
