"""The port's optimizer factory and augmentation against the JAX package's,
float32 CPU.

Augmentation is held against JAX's `_affine_resample` with explicit (flip,
angle, zoom), since torch's generator cannot reproduce `jax.random`'s bits.
Tolerance 1e-5 for the resample (float32 interpolation sums in another
order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmf_ad_tpu.data import transforms as j_transforms
from transmf_ad_tpu.train import build_optimizer as j_build_optimizer
from transmf_ad_tpu_torch.data import transforms
from transmf_ad_tpu_torch.train import (MILESTONES, build_optimizer,
                                        multistep_schedule)


@pytest.mark.parametrize("name,milestones,spe", [
    ("Adam", None, 3), ("SGD", None, 2), ("SGD", (1, 4), 5), ("Adam", (), 4)])
def test_lr_schedule_around_milestones(name, milestones, spe):
    """The lr each update uses, at the steps around every milestone, equals
    the JAX package's step-indexed schedule."""
    _, j_sched = j_build_optimizer(name, lr=1e-3, steps_per_epoch=spe,
                                   milestones=milestones)
    p = torch.nn.Parameter(torch.zeros(1))
    opt, sched = build_optimizer([p], name, lr=1e-3, steps_per_epoch=spe,
                                 milestones=milestones)
    ms = MILESTONES[name] if milestones is None else milestones
    checks = {0} | {m * spe + d for m in ms for d in (-1, 0, 1)}
    port_sched = multistep_schedule(1e-3, ms, spe)
    for step in range(max(checks) + 1):
        if step in checks:
            lr = opt.param_groups[0]["lr"]
            assert lr == pytest.approx(float(j_sched(step)), rel=1e-6), step
            assert port_sched(step) == pytest.approx(lr, rel=1e-9), step
        opt.step()
        sched.step()


def test_weight_decay_is_added_to_the_gradient():
    """torch's L2 term: the update of a zero-gradient parameter under SGD
    is -lr * wd * p, as optax.add_decayed_weights before sgd gives."""
    p = torch.nn.Parameter(torch.full((3,), 2.0))
    opt, _ = build_optimizer([p], "SGD", lr=0.1, weight_decay=0.5,
                             milestones=())
    p.grad = torch.zeros(3)
    opt.step()
    tx, _ = j_build_optimizer("SGD", lr=0.1, weight_decay=0.5,
                              milestones=())
    params = {"w": jnp.full((3,), 2.0)}
    up, _ = tx.update({"w": jnp.zeros(3)}, tx.init(params), params)
    np.testing.assert_allclose(p.detach().numpy() - 2.0,
                               np.asarray(up["w"]), rtol=1e-6)


@pytest.mark.parametrize("flip,angle,zoom", [
    (True, 0.0, 1.0), (False, 0.04, 1.0), (False, 0.0, 0.96),
    (True, -0.03, 0.97)])
def test_affine_resample(rng, flip, angle, zoom):
    vol = rng.standard_normal((11, 13, 9)).astype(np.float32)
    ref = j_transforms._affine_resample(jnp.asarray(vol), flip, angle, zoom,
                                        0)
    got = transforms._affine_resample(torch.from_numpy(vol), flip, angle,
                                      zoom, 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_augment_identity_and_scale_intensity(rng):
    vol = (3.0 * rng.standard_normal((7, 8, 9)) + 1.0).astype(np.float32)
    v = torch.from_numpy(vol)
    out = transforms.augment({"MRI": v, "PET": v}, (False, 0.0, 1.0))
    assert out["MRI"] is v and out["PET"] is v  # no resample rounding
    np.testing.assert_allclose(
        transforms.scale_intensity(v).numpy(),
        np.asarray(j_transforms.scale_intensity(jnp.asarray(vol))),
        rtol=1e-6, atol=1e-7)
    zero = transforms.scale_intensity(torch.ones(2, 2, 2))
    assert torch.equal(zero, torch.zeros(2, 2, 2))


def test_draw_params_law():
    """Probabilities and ranges of the draws (the bits differ from JAX's)."""
    cfg = transforms.AugmentConfig()
    draws = transforms.draw_params(torch.Generator().manual_seed(0), cfg,
                                   4000)
    flips = np.mean([f for f, _, _ in draws])
    rot = np.array([a for _, a, _ in draws])
    zoom = np.array([z for _, _, z in draws])
    assert abs(flips - cfg.flip_prob) < 0.03
    assert abs(np.mean(rot != 0.0) - cfg.rotate_prob) < 0.03
    assert abs(np.mean(zoom != 1.0) - cfg.zoom_prob) < 0.03
    assert np.abs(rot).max() <= cfg.rotate_range_x
    assert zoom.min() >= cfg.min_zoom and zoom.max() <= cfg.max_zoom
    again = transforms.draw_params(torch.Generator().manual_seed(0), cfg,
                                   4000)
    assert again == draws

