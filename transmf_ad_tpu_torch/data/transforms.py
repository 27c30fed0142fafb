"""3D augmentation on the device, drawn from a torch.Generator.

Port of transmf_ad_tpu/data/transforms.py, the driven reference pipeline's
transforms (reference: datasets/ADNI.py:59-132):

 - ``scale_intensity``: min-max to [0, 1]                    (ScaleIntensityd)
 - random flip of spatial axis 0, p=0.3                      (RandFlipd)
 - random rotation about axis 0, angle ~ U(-.05, .05) rad,
   p=0.3, linear, border padding                             (RandRotated)
 - random zoom ~ U(0.95, 1.0), keep-size, p=0.3              (RandZoomd)

The resample is the JAX package's separable one, not `grid_sample`: the x,
y and z zoom passes (the flip folded into the x matrix) and the rotation as
a Paeth 3-shear, each pass a matrix of linear-interpolation weights with
border clamping. The same parameters give the JAX package's result up to
float32 rounding; the random draws differ from `jax.random`'s bits.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..utils import tracing


@dataclass(frozen=True)
class AugmentConfig:
    flip_prob: float = 0.3
    flip_axis: int = 0
    rotate_prob: float = 0.3
    rotate_range_x: float = 0.05  # radians, about spatial axis 0
    zoom_prob: float = 0.3
    min_zoom: float = 0.95
    max_zoom: float = 1.0


def scale_intensity(vol: torch.Tensor) -> torch.Tensor:
    """Min-max normalise one volume to [0, 1] (constant volumes -> 0)."""
    lo, hi = vol.min(), vol.max()
    return torch.where(hi > lo, (vol - lo) / (hi - lo), torch.zeros_like(vol))


def draw_params(generator: torch.Generator, cfg: AugmentConfig, n: int = 1):
    """n draws of (flip, angle, zoom) as Python values, one per sample and
    shared by its modalities. One read of the generator's device, which
    waits for the work queued before it: the "sync" span and the
    `host_syncs` counter of `utils/tracing.py`."""
    u = torch.rand(n, 6, generator=generator, device=generator.device)
    with tracing.span("sync"):
        u = u.tolist()
    tracing.count("host_syncs")
    out = []
    for p_flip, p_rot, u_rot, p_zoom, u_zoom, _ in u:
        lo, hi = -cfg.rotate_range_x, cfg.rotate_range_x
        angle = lo + (hi - lo) * u_rot if p_rot < cfg.rotate_prob else 0.0
        zoom = (cfg.min_zoom + (cfg.max_zoom - cfg.min_zoom) * u_zoom
                if p_zoom < cfg.zoom_prob else 1.0)
        out.append((p_flip < cfg.flip_prob, angle, zoom))
    return out


def _interp_matrix(size: int, src: torch.Tensor) -> torch.Tensor:
    """Linear-interpolation matrix M (size_src, *src.shape): out[dst] =
    sum_src M[src, dst] * in[src], border-clamped. `src` holds the
    fractional source coordinate of each destination index."""
    lo = torch.clamp(torch.floor(src), 0, size - 1)
    w = torch.clamp(src - lo, 0.0, 1.0)
    hi = torch.clamp(lo + 1, 0, size - 1)
    rows = torch.arange(size, dtype=src.dtype, device=src.device)
    rows = rows.reshape((size,) + (1,) * src.dim())
    return (rows == lo[None]) * (1.0 - w)[None] + (rows == hi[None]) * w[None]


def _affine_resample(vol, flip: bool, angle: float, zoom: float,
                     flip_axis: int = 0):
    """flip -> rotate (about axis 0) -> zoom of one (X, Y, Z) volume, as
    the JAX package's separable passes, in float32."""
    X, Y, Z = vol.shape
    cx, cy, cz = (X - 1) / 2.0, (Y - 1) / 2.0, (Z - 1) / 2.0
    f32 = dict(dtype=torch.float32, device=vol.device)
    v = vol.float()

    # x pass: zoom + optional flip (src = mirror((dst-c)/zoom + c))
    dx = torch.arange(X, **f32)
    src_x = (dx - cx) / zoom + cx
    if flip:
        src_x = (X - 1) - src_x
    v = torch.einsum("xyz,xX->Xyz", v, _interp_matrix(X, src_x))

    dy = torch.arange(Y, **f32)
    v = torch.einsum("xyz,yY->xYz", v, _interp_matrix(Y, (dy - cy) / zoom + cy))
    dz = torch.arange(Z, **f32)
    v = torch.einsum("xyz,zZ->xyZ", v, _interp_matrix(Z, (dz - cz) / zoom + cz))

    # rotation about axis 0 via 3 shears in the (y, z) plane
    a = -math.tan(angle / 2.0)
    b = math.sin(angle)
    zrel = dz - cz
    yrel = dy - cy

    def shear_y(v, coef):
        src = dy[:, None] - coef * zrel[None, :]  # (Ydst, Z)
        return torch.einsum("xyz,yYz->xYz", v, _interp_matrix(Y, src))

    def shear_z(v, coef):
        src = dz[None, :] - coef * yrel[:, None]  # (Y, Zdst)
        return torch.einsum("xyz,zZy->xyZ", v, _interp_matrix(Z, src.T))

    v = shear_y(v, a)
    v = shear_z(v, b)
    v = shear_y(v, a)
    return v.to(vol.dtype)


def is_identity(flip: bool, angle: float, zoom: float) -> bool:
    return not flip and angle == 0.0 and zoom == 1.0


def augment(vols, params, cfg: AugmentConfig = AugmentConfig()):
    """Apply one draw (flip, angle, zoom) to a dict of same-shaped (X, Y, Z)
    volumes; the identity draw returns them untouched (no resample
    rounding)."""
    if is_identity(*params):
        return dict(vols)
    return {k: _affine_resample(v, *params, cfg.flip_axis)
            for k, v in vols.items()}


def spatial_pad(vol, target_shape):
    """Center-pad a numpy array or a tensor to `target_shape` with zeros.

    Port of transmf_ad_tpu/data/transforms.py::spatial_pad, after MONAI
    SpatialPadd (reference: datasets/ADNI.py:93,122): symmetric padding, the
    extra voxel on the trailing side when the difference is odd. Never crops
    (a target dim smaller than the volume's leaves it unchanged); a volume
    that needs no padding is returned as it is.
    """
    pads = []
    for s, t in zip(vol.shape, target_shape):
        d = max(t - s, 0)
        pads.append((d // 2, d - d // 2))
    if all(p == (0, 0) for p in pads):
        return vol
    if isinstance(vol, torch.Tensor):
        # F.pad takes (before, after) pairs from the last dim backwards
        flat = [n for p in reversed(pads) for n in p]
        return torch.nn.functional.pad(vol, flat)
    return np.pad(vol, pads)
