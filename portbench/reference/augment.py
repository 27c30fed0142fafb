"""The training augmentation, plain: one draw per sample, shared by its
modalities, of (flip of axis 0 with p 0.3, rotation about axis 0 by
U(-0.05, 0.05) rad with p 0.3, zoom U(0.95, 1.0) with p 0.3), from one
float32 `torch.rand(n, 6)` of the train step's generator (columns: flip,
rotate, angle, zoom, factor, unused). The resample is separable, linear
and border-clamped, as the reference pipeline's port defines it: the x pass
zooms (and mirrors when flipped), the y and z passes zoom, and the rotation
is three shears in the (y, z) plane (y by -tan(a/2), z by sin(a), y by
-tan(a/2)). Each pass gathers the two neighbours of every source coordinate
and mixes them, in float32. A draw that changes nothing leaves the volume
untouched."""

from __future__ import annotations

import math

import torch


def draw(generator, n, cfg):
    u = torch.rand(n, 6, generator=generator,
                   device=generator.device).tolist()
    out = []
    for p_flip, p_rot, u_rot, p_zoom, u_zoom, _ in u:
        lo, hi = -cfg["rotate_range_x"], cfg["rotate_range_x"]
        angle = lo + (hi - lo) * u_rot if p_rot < cfg["rotate_prob"] else 0.0
        zoom = (cfg["min_zoom"] + (cfg["max_zoom"] - cfg["min_zoom"]) * u_zoom
                if p_zoom < cfg["zoom_prob"] else 1.0)
        out.append((p_flip < cfg["flip_prob"], angle, zoom))
    return out


def _mix(v, axis, src):
    """out[..., d, ...] = linear interpolation of v along `axis` at the
    fractional source coordinate src (broadcast against v's other axes
    after moving `axis` first), clamped to the border."""
    size = v.shape[axis]
    lo = torch.clamp(torch.floor(src), 0, size - 1)
    w = torch.clamp(src - lo, 0.0, 1.0)
    hi = torch.clamp(lo + 1, 0, size - 1)
    vt = v.movedim(axis, 0)
    idx_shape = src.shape + (1,) * (vt.dim() - src.dim())
    full = (src.shape[0],) + vt.shape[1:]
    a = torch.gather(vt, 0, lo.long().reshape(idx_shape).expand(full))
    b = torch.gather(vt, 0, hi.long().reshape(idx_shape).expand(full))
    wv = w.reshape(idx_shape)
    return (a * (1.0 - wv) + b * wv).movedim(0, axis)


def resample(vol, flip, angle, zoom):
    """One (X, Y, Z) float32 volume through the draw's passes."""
    X, Y, Z = vol.shape
    dev = vol.device
    cx, cy, cz = (X - 1) / 2.0, (Y - 1) / 2.0, (Z - 1) / 2.0
    dx = torch.arange(X, dtype=torch.float32, device=dev)
    dy = torch.arange(Y, dtype=torch.float32, device=dev)
    dz = torch.arange(Z, dtype=torch.float32, device=dev)
    src_x = (dx - cx) / zoom + cx
    if flip:
        src_x = (X - 1) - src_x
    v = _mix(vol, 0, src_x)
    v = _mix(v, 1, (dy - cy) / zoom + cy)
    v = _mix(v, 2, (dz - cz) / zoom + cz)
    a, b = -math.tan(angle / 2.0), math.sin(angle)
    # shear of y by z: out[x, Yd, z] = v at y = Yd - c * (z - cz)
    ysrc = lambda c: dy[:, None] - c * (dz - cz)[None, :]  # noqa: E731
    # shear of z by y: out[x, y, Zd] = v at z = Zd - c * (y - cy), gathered
    # along z with y kept: indices (Zd, y) after moving z first
    zsrc = lambda c: (dz[:, None] - c * (dy - cy)[None, :])  # noqa: E731

    def shear_y(v, c):
        return _mix(v.permute(1, 2, 0), 0, ysrc(c)).permute(2, 0, 1)

    def shear_z(v, c):
        return _mix(v.permute(2, 1, 0), 0, zsrc(c)).permute(2, 1, 0)

    return shear_y(shear_z(shear_y(v, a), b), a)


def augment(vol, params):
    flip, angle, zoom = params
    if not flip and angle == 0.0 and zoom == 1.0:
        return vol
    return resample(vol, flip, angle, zoom)
