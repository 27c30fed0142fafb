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

A batch is augmented by `augment_batch` from the step's (B, 6) uniforms,
one draw per sample shared by its modalities. On CUDA tensors that is one
launch of kernel K13 (csrc/augment.cu), which decodes the uniforms on the
device, so the host never reads them; on CPU tensors it is the plain
version, `augment_reference`: `decode` on the host (the "sync" span and
the `host_syncs` counter of `utils/tracing.py`), then `augment` a sample at
a time.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from .._build import DOUBLE, INT, PTR, Kernel, check_cuda, library
from ..utils import tracing

AUGMENT = Kernel(
    name="augment", entry="transmf_augment",
    argtypes=(PTR,) * 4 + (INT, PTR, INT, INT, INT, INT) + (DOUBLE,) * 7
    + (INT, PTR, INT),
    source="transmf_ad_tpu_torch/csrc/augment.cu",
    replaces="none: transmf_ad_tpu/data/transforms.py:172 (XLA)")
MAX_MODALITIES = 2  # the C entry's input and output slots: MRI and PET


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


def draw_uniforms(generator: torch.Generator, n: int) -> torch.Tensor:
    """The (n, 6) float32 uniforms of n draws, on the generator's device
    (columns: flip, rotate, angle, zoom, factor, unused)."""
    return torch.rand(n, 6, generator=generator, device=generator.device)


def draw_params(generator: torch.Generator, cfg: AugmentConfig, n: int = 1):
    """n draws of (flip, angle, zoom) as Python values, one per sample and
    shared by its modalities (`decode` of `draw_uniforms`)."""
    return decode(draw_uniforms(generator, n), cfg)


def decode(u: torch.Tensor, cfg: AugmentConfig):
    """The draws (flip, angle, zoom) of the (n, 6) uniforms `u`, in Python
    floats (double precision). One read of u's device, which waits for the
    work queued before it: the "sync" span and the `host_syncs` counter of
    `utils/tracing.py`."""
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


def augment_reference(vols, u: torch.Tensor, cfg: AugmentConfig):
    """The plain version of `augment_batch`: `decode` on the host, then
    `augment` one sample at a time, stacked."""
    samples = [augment({k: v[i] for k, v in vols.items()}, params, cfg)
               for i, params in enumerate(decode(u, cfg))]
    return {k: torch.stack([s[k] for s in samples]) for k in vols}


@functools.cache
def scratch_floats(y: int, z: int) -> int:
    """The device scratch a K13 block takes for Y x Z planes, in float32
    words; 0 where the shape takes the "smem" variant. The kernel library
    owns the rule (`smem_fits` in csrc/augment.cu)."""
    fn = library().transmf_augment_scratch_floats
    fn.argtypes, fn.restype = [INT, INT], ctypes.c_longlong
    return fn(y, z)


def variant(shape) -> str:
    """The K13 variant a launch takes for (B, X, Y, Z) volumes: "smem", a
    float32 Y x Z plane and the taps in shared memory, where they fit and
    no line is longer than a warp holds in registers; "global", the same
    stages in device scratch, otherwise."""
    return "global" if scratch_floats(*shape[-2:]) else "smem"


def _augment_launch(vols, u: torch.Tensor, cfg: AugmentConfig):
    """K13 on CUDA tensors: one launch for every sample and modality."""
    names = list(vols)
    ins = [vols[k].contiguous() for k in names]
    dtype = check_cuda("augment", *ins)
    x = ins[0]
    if x.dim() != 4 or any(t.shape != x.shape for t in ins):
        raise ValueError("augment: expected same-shaped (B, X, Y, Z) "
                         f"volumes, got {[tuple(t.shape) for t in ins]}")
    if len(ins) > MAX_MODALITIES:
        raise ValueError(f"augment: {len(ins)} modalities, at most "
                         f"{MAX_MODALITIES}")
    b, _, y, z = x.shape
    u = u.to(device=x.device, dtype=torch.float32).contiguous()
    if tuple(u.shape) != (b, 6):
        raise ValueError(f"augment: uniforms {tuple(u.shape)}, expected "
                         f"({b}, 6)")
    outs = [torch.empty_like(t) for t in ins]
    per_block = scratch_floats(y, z)
    scratch, blocks = None, 0
    if per_block:
        blocks = torch.cuda.get_device_properties(x.device) \
            .multi_processor_count
        scratch = torch.empty(blocks * per_block, dtype=torch.float32,
                              device=x.device)
    pad = [None] * (MAX_MODALITIES - len(ins))
    lo, hi = -cfg.rotate_range_x, cfg.rotate_range_x
    AUGMENT.launch(
        x.device, *[t.data_ptr() for t in ins], *pad,
        *[t.data_ptr() for t in outs], *pad, len(ins), u.data_ptr(),
        *x.shape, cfg.flip_prob, cfg.rotate_prob, lo, hi, cfg.zoom_prob,
        cfg.min_zoom, cfg.max_zoom, dtype,
        None if scratch is None else scratch.data_ptr(), blocks,
        variant="global" if per_block else "smem")
    tracing.count("augment.kernel")
    return dict(zip(names, outs))


def augment_batch(vols, u: torch.Tensor, cfg: AugmentConfig = AugmentConfig()):
    """Augment a dict of same-shaped (B, X, Y, Z) volume batches by the
    draws of the (B, 6) uniforms `u` (`draw_uniforms`), one draw per sample
    shared by its modalities. CPU tensors: the plain version,
    `augment_reference`; any other device: kernel K13, which reads `u` on
    the device (no host sync) and returns new tensors, or raises. An
    identity draw leaves its sample's bits untouched."""
    if next(iter(vols.values())).device.type == "cpu":
        return augment_reference(vols, u, cfg)
    return _augment_launch(vols, u, cfg)


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
