"""The operation counts from shapes against the hand-worked values and
the values they gave before each count was looked up by name."""

from __future__ import annotations

import io
import sys
import types

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


@pytest.mark.parametrize("config, volume, flops", [
    ("model_ad", (182, 218, 182), 1561498368768),
    ("model_ad", (91, 109, 91), 185695692288),
    ("transformer_res", (182, 218, 182), 1586156385024),
    ("transformer_res", (91, 109, 91), 186079013376),
])
def test_train_per_pair_by_reference(config, volume, flops):
    """Each reference's count (`counts/models/<reference>.py`) gives the
    integers that the one `forward_per_pair` of both gave before."""
    cfg = harness.load_json(harness.HERE / f"configs/{config}.json")
    assert model.train_per_pair(cfg, volume) == flops


def test_missing_model_count_names_its_file(ad):
    with pytest.raises(ValueError, match="portbench/counts/models/no_such_"
                                         "net.py"):
        model.train_per_pair(dict(ad, reference="no_such_net"), (91, 109, 91))


@pytest.fixture
def op_dir(tmp_path, monkeypatch):
    """A directory searched for `counts/ops/<op>.py` besides the
    benchmark's own, with the modules it gives dropped afterwards."""
    from portbench.counts import ops

    monkeypatch.setattr(ops, "__path__", [*ops.__path__, str(tmp_path)])
    yield tmp_path
    for name in [m for m in sys.modules if m.startswith(ops.__name__ + ".")]:
        del sys.modules[name]


SCALE = '''
def outputs(shapes):
    return [(shapes[0], None)]


def ops(shapes):
    n = 1
    for s in shapes[0]:
        n *= s
    return 3 * n * shapes[0][-1], "f32"
'''


@pytest.mark.parametrize("shape, dtype, size, binds", [
    ([1024, 2], "c10::BFloat16", 2, "bytes"),
    ([4, 4096], "float", 4, "operations")])
def test_op_with_a_count_file_is_counted(op_dir, shape, dtype, size, binds):
    (op_dir / "tiny_scale.py").write_text(SCALE)
    n = shape[0] * shape[1]
    by_bytes = 2 * size * n / peaks.HBM_BYTES_PER_S  # read once, written once
    by_ops = 3 * n * shape[1] / peaks.FLOPS["float32"]
    t, kind = kernels.least_time_s("tiny_scale", [shape, []],
                                   [dtype, "Scalar"])
    assert kind == binds
    assert t == pytest.approx(max(by_bytes, by_ops), rel=1e-12)


BAND = ([[6, 91, 109, 91, 32], [3, 3, 3, 32, 64]], ["c10::BFloat16"] * 2)


def test_uncounted_op_is_skipped_and_reported(op_dir):
    """A synthetic trace: two band_conv calls, a counted new op and an op
    with no count. The sums hold the counted calls alone, by op and in
    all; the op with no count is named once on the log; one op's share of
    its roofline reads from the sums."""
    from portbench import profiling, readers

    (op_dir / "tiny_scale.py").write_text(SCALE)
    assert kernels.least_time_s("no_count_op", [[4]], ["float"]) is None
    band, _ = kernels.least_time_s("band_conv", *BAND)
    scale, _ = kernels.least_time_s("tiny_scale", [[4, 4]], ["float"])
    out = profiling.Trace(window_s=1.0, units=2, busy_s=0.5)
    log = io.StringIO()
    profiling.add_op_calls(out, [
        ("band_conv", *BAND, 2e-3), ("no_count_op", [[4]], ["float"], 5e-3),
        ("tiny_scale", [[4, 4]], ["float"], 1e-6),
        ("band_conv", *BAND, 4e-3), ("no_count_op", [[4]], ["float"], 7e-3)],
        log)
    assert out.op_least_s == band + scale + band
    assert out.op_device_s == 2e-3 + 1e-6 + 4e-3
    assert out.by_op == {
        "band_conv": {"least_s": band + band, "device_s": 2e-3 + 4e-3},
        "tiny_scale": {"least_s": scale, "device_s": 1e-6}}
    assert out.uncounted == {"no_count_op": {"calls": 2,
                                             "device_s": 5e-3 + 7e-3}}
    lines = log.getvalue().splitlines()
    assert lines == [f"uncounted transmf::no_count_op 2 {1e3 * 12e-3!r}"]

    ctx = types.SimpleNamespace(trace=out)
    assert readers.op_roofline_pct(ctx, ["band_conv"]) == \
        pytest.approx(100 * 2 * band / 6e-3)
    assert readers.op_roofline_pct(ctx, ["band_conv", "tiny_scale"]) == \
        pytest.approx(100 * (2 * band + scale) / (6e-3 + 1e-6))
    assert readers.kernels_roofline_pct(ctx) == \
        pytest.approx(100 * (2 * band + scale) / (6e-3 + 1e-6))
    assert readers.op_roofline_pct(ctx, ["flash_fwd"]) is None  # not run
    assert readers.op_roofline_pct(ctx, ["no_count_op"]) is None
    assert readers.op_roofline_pct(types.SimpleNamespace(trace=None),
                                   ["band_conv"]) is None


BF, F, S = "c10::BFloat16", "float", "Scalar"
F1, F2 = [6, 182, 218, 182], [6, 91, 109, 91]  # the cells' two grids
POOL = [[5824], [5824], [], [], [], []], [F, F, S, "", S, S]
QKV = [[6, 4, 1573, 32], [6, 4, 3146, 32], [6, 4, 3146, 32]]
FLASH_BWD = (QKV + [[6, 4, 1573, 32], [6, 4, 1573], [6, 4, 1573], []],
             [BF] * 4 + [F, F, S])
C128 = [[128], [128], [], [], [], []]


def _pool_bwd(x, y):
    return [x, POOL[0][0], POOL[0][1], y, y, [], [], [], []]


# every transmf:: call of the two cells' train step, its shapes and dtypes
# as the card's profiler recorded them (stem_conv, the eval stem, at the
# train stem's shapes), and the least time the count gave before any op
# was looked up by name
@pytest.mark.parametrize("op, shapes, dtypes, seconds, binds", [
    ("affine_act_pool", [[*F1, 32], *POOL[0]], [BF, *POOL[1]],
     0.0009312037062686568, "bytes"),
    ("affine_act_pool", [[6, 22, 27, 22, 128], *C128], [BF, *POOL[1]],
     6.713313432835821e-06, "bytes"),
    ("affine_act_pool", [[6, 45, 54, 45, 128], *C128], [BF, *POOL[1]],
     5.612987223880597e-05, "bytes"),
    ("affine_act_pool", [[*F2, 64], *POOL[0]], [BF, *POOL[1]],
     0.00023201386985074627, "bytes"),
    ("affine_act_pool_bwd", _pool_bwd([*F1, 32], [*F2, 32]),
     [BF, F, F, BF, BF, S, "", S, S], 0.0018624074125373135, "bytes"),
    ("affine_act_pool_bwd",
     [[6, 22, 27, 22, 128], [128], [128], [6, 11, 13, 11, 128],
      [6, 11, 13, 11, 128], [], [], [], []],
     [BF, F, F, BF, BF, S, "", S, S], 1.3426626865671642e-05, "bytes"),
    ("affine_act_pool_bwd",
     [[6, 45, 54, 45, 128], [128], [128], [6, 22, 27, 22, 128],
      [6, 22, 27, 22, 128], [], [], [], []],
     [BF, F, F, BF, BF, S, "", S, S], 0.00011225974447761193, "bytes"),
    ("affine_act_pool_bwd", _pool_bwd([*F2, 64], [6, 45, 54, 45, 64]),
     [BF, F, F, BF, BF, S, "", S, S], 0.00046402773970149254, "bytes"),
    ("attention", [[6, 4, 1573, 32]] * 3 + [[]], [BF] * 3 + [S],
     7.6856811809909e-06, "operations"),
    ("band_conv", [[*F2, 32], [3, 3, 3, 32, 32]], [BF, BF],
     0.0003028014551102123, "operations"),
    ("band_conv", [[*F2, 64], [3, 3, 3, 64, 32]], [BF, BF],
     0.0006056029102204246, "operations"),
    ("band_conv_stats", [[*F2, 32], [3, 3, 3, 32, 32]], [BF, BF],
     0.0003028014551102123, "operations"),
    ("band_conv_stats", [[*F2, 32], [3, 3, 3, 32, 64]], [BF, BF],
     0.0006056029102204246, "operations"),
    ("band_dw", [[*F2, 32]] * 3 + [[32], [32]], [BF] * 3 + [F, F],
     0.00031042968835820895, "bytes"),
    ("band_dw", [[*F2, 32], [*F2, 64], [*F2, 64], [64], [64]],
     [BF] * 3 + [F, F], 0.0006056029102204246, "operations"),
    ("stem_conv", [F1, [3, 3, 3, 32]], [BF, BF],
     0.0008535911641791045, "bytes"),
    ("stem_conv_stats", [F1, [3, 3, 3, 32]], [BF, BF],
     0.000853591240597015, "bytes"),
    ("stem_dw", [F1, [*F1, 32], [*F1, 32], [32], [32]], [BF] * 3 + [F, F],
     0.0016813160214925373, "bytes"),
    ("token_pool", [[6, 1573, 128]] * 2, [BF, BF],
     1.4442985074626865e-06, "bytes"),
    ("flash_fwd", QKV + [[]], [BF] * 3 + [S],
     1.53713623619818e-05, "operations"),
    ("flash_dq", *FLASH_BWD, 2.30570435429727e-05, "operations"),
    ("flash_dkv", *FLASH_BWD, 3.07427247239636e-05, "operations"),
])
def test_least_time_at_the_cells_shapes(op, shapes, dtypes, seconds, binds):
    assert kernels.least_time_s(op, shapes, dtypes) == (seconds, binds)
