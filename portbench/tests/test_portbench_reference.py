"""The plain reference against the program on the CPU at a tiny size, in
float32: the program's plain versions and the reference agree; the fp8
control, put in the program's place, does not; the calibration's planted
fault and its look at rounding read what they should."""

from __future__ import annotations

import pytest
import torch

from portbench import calibrate
from portbench.kinds import train_step
from portbench.reference import augment, step
from portbench.reference.layers import Precision
from portbench.tests import tiny


def test_augmentation_matches_the_program():
    from transmf_ad_tpu_torch.data import transforms

    v = torch.rand(20, 24, 18)
    for params in [(True, 0.0, 1.0), (False, 0.04, 1.0), (False, 0.0, 0.96),
                   (True, -0.03, 0.97)]:
        assert torch.allclose(transforms._affine_resample(v, *params),
                              augment.resample(v, *params), atol=1e-6)
    cfg = tiny.cell_files(tiny.CELLS[0])[2]["augment"]
    g1, g2 = (torch.Generator().manual_seed(5) for _ in range(2))
    assert transforms.draw_params(g1, transforms.AugmentConfig(**cfg), 8) \
        == augment.draw(g2, 8, cfg)


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_train_step_agrees_in_float32(cell):
    assert tiny.run(cell)["correct"]
    entry, cfg, mix, limits = tiny.cell_files(cell)
    drv = train_step.CellRun(cfg, mix, 12, "cpu", limits)
    drv.setup()
    drv.release()
    nums = drv.numbers(drv.reference())
    assert nums["out"] < 1e-5 and nums["feat"] < 1e-5, nums
    assert nums["loss1"] < 1e-5, nums
    assert nums["grad"] < 1e-4 and nums.get("grad_out", 0) < 1e-4, nums
    # Adam's first steps move each weight by about lr * sign(g): a weight
    # whose gradient is rounding-sized moves either way, so the change's
    # norm is looser than the gradient's
    assert nums["update"] < 1e-2, nums


def test_train_control_is_not_correct():
    entry, cfg, mix, limits = tiny.cell_files(tiny.CELLS[0])
    drv = train_step.CellRun(cfg, mix, 11, "cpu", limits)
    drv.setup()
    drv.release()
    ref = drv.reference()
    ctl = drv.reference(Precision("fp8"))
    nums = train_step.gaps(ctl[0], ctl[3], ctl[4], ctl[1], drv.p0, ctl[2],
                           ref)
    assert any(nums[k] > limits[k]["limit"] for k in limits), nums


def test_calibration_readings():
    """The half-batch fault in the reference moves the gradient and keeps
    the outputs, the altered answer moves the outputs; the reference
    against itself reads rounding alone, and the pool winners it counts
    are there."""
    entry, cfg, mix, limits = tiny.cell_files(tiny.CELLS[0])
    r = calibrate.readings(cfg, mix, limits, 13, "cpu", half=True,
                           altered=True, look=True)
    assert r["half"]["out"] < 1e-5 and r["half"]["grad"] > 0.05, r["half"]
    assert r["altered"]["out"] > 0.05, r["altered"]
    assert r["half"]["loss1"] > 1e-4, r["half"]
    same = r["look_0"]
    assert not any(same.pop("out_each")), same
    assert all(v == 0 for v in same.values()), same
    moved, windows = r["look_0_pool_winners_moved"]
    assert moved == 0 and windows > 0
    assert r["look_1.19209e-07"]["grad"] < 1e-3
    assert 0 < r["look_features_1e-06"]["feat"] < 1e-5


def test_a_non_finite_number_reads_mismatch():
    """A leaf, an output or a feature that is not finite fails its number
    whatever the other leaves read."""
    g = {f"l{i}.weight": torch.ones(3) for i in range(5)}
    p0 = {k: torch.zeros(3) for k in g}
    p3 = {k: v + 0.1 for k, v in p0.items()}
    bad = dict(g)
    bad["l0.weight"] = torch.tensor([1.0, float("nan"), 1.0])
    out, feat = [torch.ones(2, 2)], [torch.ones(1, 2, 2, 2, 3)]
    ref = ([1.0], g, p3, out, [torch.ones(1, 3, 2, 2, 2)])
    sound = train_step.gaps([1.0], out, feat, g, p0, p3, ref, ("l1",))
    assert all(v == 0 for v in sound.values()), sound
    nums = train_step.gaps([1.0], [torch.full((2, 2), float("nan"))], feat,
                           bad, p0, p3, ref, ("l0",))
    for k in ("out", "grad", "grad_out"):
        assert nums[k] == train_step.MISMATCH, nums
