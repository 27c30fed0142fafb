"""Exact-MONAI augmentation mode (host-side, numpy).

The production augmentation path (`transforms.augment`, inside the train
step) is a separable device resample: flip/rotate/zoom as banded-matmul
passes on the card — augmentation-grade equivalent to MONAI but not bit-matching its
per-transform resamples. This module is the EXACT mode: it reproduces the
reference's MONAI 1.3.2 pipeline transform-for-transform on the host (as
MONAI itself runs), so cross-framework training-curve comparisons see
identical inputs given identical draws. Reference pipeline
(reference: datasets/ADNI.py:66-69):

    RandFlipd(prob=.3, spatial_axis=0)
    RandRotated(prob=.3, range_x=.05)     # defaults: keep_size=True,
                                          # bilinear, border, align_corners=False
    RandZoomd(prob=.3, min_zoom=.95, max_zoom=1)
                                          # defaults: mode='area',
                                          # padding_mode='edge', keep_size=True

MONAI semantics reproduced here (monai 1.3.2 sources):

- ``Rotate`` builds the pixel-space affine ``shift(c) @ create_rotate(a)
  @ shift(-c)`` with ``c = (shape - 1) / 2`` (keep_size=True ->
  output shape = input shape) and resamples through
  ``AffineTransform(normalized=False, reverse_indexing=True)`` ==
  ``torch.nn.functional.grid_sample(mode='bilinear',
  padding_mode='border', align_corners=False)``. For a rotation about
  spatial axis 0 the source coordinate of output voxel (x, y, z) is
      y_s = cos(a)(y - cy) - sin(a)(z - cz) + cy
      z_s = sin(a)(y - cy) + cos(a)(z - cz) + cz
  with x untouched; border padding clamps (y_s, z_s) into the volume
  before bilinear interpolation. `rotate` implements exactly that
  (verified against the torch oracle in tests/test_exact_monai.py).
- ``Zoom`` calls ``torch.nn.functional.interpolate(scale_factor=zoom,
  mode='area', recompute_scale_factor=True)`` — output size
  floor(size * zoom) per axis, area interpolation == adaptive average
  pooling (bin [floor(i*L/O), ceil((i+1)*L/O))), which is separable per
  axis — then keep_size=True pads back with half = diff // 2 leading /
  diff - half trailing voxels in 'edge' (replicate) mode.
- Rand*d dict transforms draw ONCE per sample and apply the same draw to
  every key (MRI and PET share flip/angle/zoom), each transform gated by
  its own probability. The RNG STREAM is this module's own
  (`np.random.Generator`), not MONAI's RandomState — draws are
  distribution-identical, not sequence-identical; for bit-level
  cross-framework runs feed explicit params via `rotate`/`zoom`.

All math is float32, like the reference pipeline after ScaleIntensity.
This path exists for validation/comparison; it runs per-sample on the
host (exactly as the reference does) and is selected with
``--aug_exact True`` / ``TrainerConfig.aug_exact``.

A copy of transmf_ad_tpu/data/exact_monai.py (numpy only); the device
resample it stands beside is `data/transforms.py`'s.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .transforms import AugmentConfig

__all__ = ["flip", "rotate", "zoom", "augment_exact", "make_sample_transform"]


def flip(vol: np.ndarray, axis: int = 0) -> np.ndarray:
    """RandFlipd's applied transform: reverse one spatial axis."""
    return np.flip(vol, axis=axis).copy()


def rotate(vol: np.ndarray, angle: float) -> np.ndarray:
    """MONAI Rotate(angle about spatial axis 0, keep_size=True,
    mode='bilinear', padding_mode='border', align_corners=False)."""
    v = np.asarray(vol, dtype=np.float32)
    X, Y, Z = v.shape
    cy, cz = (Y - 1) / 2.0, (Z - 1) / 2.0
    cos, sin = np.cos(angle), np.sin(angle)
    yg = (np.arange(Y, dtype=np.float64) - cy)[:, None]
    zg = (np.arange(Z, dtype=np.float64) - cz)[None, :]
    ys = cos * yg - sin * zg + cy
    zs = sin * yg + cos * zg + cz
    # grid_sample padding_mode='border': clamp the float coordinate
    ys = np.clip(ys, 0.0, Y - 1)
    zs = np.clip(zs, 0.0, Z - 1)
    y0 = np.floor(ys).astype(np.int64)
    z0 = np.floor(zs).astype(np.int64)
    wy = (ys - y0).astype(np.float32)
    wz = (zs - z0).astype(np.float32)
    y1 = np.minimum(y0 + 1, Y - 1)
    z1 = np.minimum(z0 + 1, Z - 1)
    out = ((1 - wy) * (1 - wz)) * v[:, y0, z0] \
        + ((1 - wy) * wz) * v[:, y0, z1] \
        + (wy * (1 - wz)) * v[:, y1, z0] \
        + (wy * wz) * v[:, y1, z1]
    return out


def _area_matrix(n_in: int, n_out: int) -> np.ndarray:
    """Per-axis 'area' interpolation matrix (adaptive average pooling):
    out[i] = mean(in[floor(i*n_in/n_out) : ceil((i+1)*n_in/n_out)])."""
    m = np.zeros((n_out, n_in), np.float32)
    for i in range(n_out):
        s = (i * n_in) // n_out
        e = -((-(i + 1) * n_in) // n_out)  # ceil
        m[i, s:e] = 1.0 / (e - s)
    return m


def zoom(vol: np.ndarray, factor: float) -> np.ndarray:
    """MONAI Zoom(zoom=factor, mode='area', padding_mode='edge',
    keep_size=True): interpolate to floor(size * factor) per axis
    (recompute_scale_factor=True), then pad back (half = diff // 2
    leading) in replicate mode. factor may exceed 1 (then keep_size
    center-crops with the same half split)."""
    v = np.asarray(vol, dtype=np.float32)
    orig = v.shape
    out_shape = [int(np.floor(float(s) * factor)) for s in orig]
    # separable area interpolation (box means factor per axis)
    for ax, (n_in, n_out) in enumerate(zip(orig, out_shape)):
        if n_in != n_out:
            v = np.moveaxis(
                np.tensordot(_area_matrix(n_in, n_out), v, axes=(1, ax)),
                0, ax)
    # keep_size: pad (diff > 0) or crop (diff < 0), half leading
    pad_vec = []
    slice_vec = []
    for od, zd in zip(orig, v.shape):
        diff = od - zd
        half = abs(diff) // 2
        pad_vec.append((half, diff - half) if diff > 0 else (0, 0))
        slice_vec.append(slice(half, half + od) if diff < 0 else slice(None))
    if any(p != (0, 0) for p in pad_vec):
        v = np.pad(v, pad_vec, mode="edge")
    return v[tuple(slice_vec)]


def augment_exact(sample: Dict[str, np.ndarray], rng: np.random.Generator,
                  cfg: AugmentConfig = AugmentConfig()) -> Dict[str, np.ndarray]:
    """Apply the reference MONAI train pipeline to one sample dict.

    Volume keys (float arrays of >= 3 dims) share one draw per transform;
    non-array entries (label, ...) pass through. Output volumes are
    float32 (MONAI resamples in float32)."""
    do_flip = rng.random() < cfg.flip_prob
    do_rot = rng.random() < cfg.rotate_prob
    angle = float(rng.uniform(-cfg.rotate_range_x, cfg.rotate_range_x))
    do_zoom = rng.random() < cfg.zoom_prob
    factor = float(rng.uniform(cfg.min_zoom, cfg.max_zoom))

    out = {}
    for k, val in sample.items():
        v = np.asarray(val)
        if v.ndim < 3:
            out[k] = val
            continue
        v = v.astype(np.float32)
        if do_flip:
            v = flip(v, cfg.flip_axis)
        if do_rot:
            v = rotate(v, angle)
        if do_zoom:
            v = zoom(v, factor)
        out[k] = v
    return out


def make_sample_transform(seed: int, cfg: AugmentConfig = AugmentConfig()):
    """A `Loader` sample_transform applying the exact pipeline with its
    own RNG stream (one draw sequence per loader, like a MONAI Dataset)."""
    rng = np.random.default_rng(seed)

    def transform(sample: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        return augment_exact(sample, rng, cfg)

    return transform
