"""The port's exact-MONAI host augmentation against the JAX package's.

`data/exact_monai.py` is numpy in both packages: `flip`, `rotate`, `zoom`,
`augment_exact` and `make_sample_transform` give the same bits on the same
inputs and draws, over several seeds. The Trainer's `_cast_after_transform`
runs the float32 transform first and casts after it: to a `torch.bfloat16`
tensor for bfloat16 (the JAX package's ml_dtypes bfloat16 array, bit for
bit), to float32 numpy otherwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmf_ad_tpu.data import exact_monai as j_exact
from transmf_ad_tpu.data.transforms import AugmentConfig as JAugmentConfig
from transmf_ad_tpu.train import trainer as j_trainer
from transmf_ad_tpu_torch.data import exact_monai
from transmf_ad_tpu_torch.data.transforms import AugmentConfig
from transmf_ad_tpu_torch.train.trainer import _cast_after_transform

SEEDS = range(4)
SHAPE = (13, 16, 11)


def _vol(seed):
    return np.random.default_rng(seed).random(SHAPE, np.float32)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", SEEDS)
def test_flip_rotate_zoom(seed):
    v = _vol(seed)
    rng = np.random.default_rng(100 + seed)
    for axis in range(3):
        _same(exact_monai.flip(v, axis), j_exact.flip(v, axis))
    angle = float(rng.uniform(-0.3, 0.3))
    _same(exact_monai.rotate(v, angle), j_exact.rotate(v, angle))
    for factor in (0.95, float(rng.uniform(0.9, 1.0)), 1.07):
        _same(exact_monai.zoom(v, factor), j_exact.zoom(v, factor))


@pytest.mark.parametrize("seed", SEEDS)
def test_augment_exact(seed):
    cfg = dict(flip_prob=0.5, rotate_prob=0.5, zoom_prob=0.5)
    sample = {"MRI": _vol(seed), "PET": _vol(seed + 50),
              "label": np.int32(seed % 2)}
    for draw in range(4):  # several draws of one stream
        got = exact_monai.augment_exact(
            sample, np.random.default_rng([seed, draw]),
            AugmentConfig(**cfg))
        want = j_exact.augment_exact(
            sample, np.random.default_rng([seed, draw]),
            JAugmentConfig(**cfg))
        assert got.keys() == want.keys()
        for k in got:
            _same(got[k], want[k])


@pytest.mark.parametrize("seed", SEEDS)
def test_make_sample_transform(seed):
    ours = exact_monai.make_sample_transform(seed, AugmentConfig(
        zoom_prob=1.0))
    theirs = j_exact.make_sample_transform(seed, JAugmentConfig(
        zoom_prob=1.0))
    for i in range(3):
        sample = {"MRI": _vol(i), "PET": _vol(i + 9), "label": np.int32(1)}
        got, want = ours(sample), theirs(sample)
        for k in ("MRI", "PET"):
            _same(got[k], want[k])
        assert got["MRI"].shape == SHAPE  # keep_size


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cast_after_transform(dtype):
    seen = []

    def transform(item):
        seen.append(np.asarray(item["MRI"]).dtype)
        return exact_monai.augment_exact(item, np.random.default_rng(0))

    port_dt = {"bfloat16": torch.bfloat16, "float32": torch.float32}[dtype]
    jax_dt = {"bfloat16": jnp.bfloat16, "float32": jnp.float32}[dtype]
    item = {"MRI": _vol(1), "PET": _vol(2), "label": np.int32(0)}
    got = _cast_after_transform(transform, ("MRI", "PET"), port_dt)(item)
    want = j_trainer._cast_after_transform(transform, ("MRI", "PET"),
                                           jax_dt)(item)
    assert seen == [np.float32, np.float32]  # the transform ran in float32
    for k in ("MRI", "PET"):
        if dtype == "bfloat16":
            assert got[k].dtype == torch.bfloat16
            np.testing.assert_array_equal(
                got[k].view(torch.int16).numpy().view(np.uint16),
                np.asarray(want[k]).view(np.uint16))
        else:
            _same(got[k], want[k])
    assert got["label"] == 0
