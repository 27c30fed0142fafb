"""Synthetic MRI / PET volumes, drawn on the card from a generator in a few
large calls. Each volume is min-max scaled to [0, 1] as the reference
pipeline scales its volumes, and differs from the next in what a subject
and a scanner change: its own intensity window [lo, hi] (lo ~ U(0, 0.4),
hi ~ U(0.6, 1)) and its own mix of voxel noise and a smooth gradient
across the volume (of random direction, weight ~ U(0.1, 0.7)). Volumes
that were all i.i.d. noise of one law would have near-identical means,
and the models' BatchNorm over a few pooled features would then amplify
rounding without bound."""

from __future__ import annotations

import torch

CHUNK = 8  # volumes drawn at a time: bounds the float32 scratch memory


def fill(out: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Fill `out` (N, X, Y, Z), any float dtype, on the generator's device."""
    n, X, Y, Z = out.shape
    dev = out.device
    per = torch.rand(n, 6, generator=generator, device=dev)
    lo, hi = 0.4 * per[:, 0], 0.6 + 0.4 * per[:, 1]
    w = 0.1 + 0.6 * per[:, 2]
    d = per[:, 3:6] + 0.1  # the gradient's direction, positive parts
    d = d / d.sum(dim=1, keepdim=True)
    axes = [torch.linspace(0, 1, s, device=dev) for s in (X, Y, Z)]
    for i in range(0, n, CHUNK):
        j = min(i + CHUNK, n)
        u = torch.rand((j - i, X, Y, Z), generator=generator, device=dev)
        ramp = (d[i:j, 0, None, None, None] * axes[0][None, :, None, None]
                + d[i:j, 1, None, None, None] * axes[1][None, None, :, None]
                + d[i:j, 2, None, None, None] * axes[2][None, None, None, :])
        mixw = w[i:j, None, None, None]
        v = (1 - mixw) * u + mixw * ramp
        out[i:j] = (lo[i:j, None, None, None]
                    + (hi - lo)[i:j, None, None, None] * v).to(out.dtype)
    return out
