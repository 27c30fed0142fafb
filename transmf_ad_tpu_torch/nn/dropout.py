"""Dropout that draws from an explicit torch.Generator.

The JAX package draws dropout masks from a `jax.random` key threaded through
the train step; the port threads a `torch.Generator` the same way (nn.Dropout
takes none). The masks differ from JAX's bits; their law is the same: each
unit is kept with probability 1 - p and scaled by 1 / (1 - p).
"""

from __future__ import annotations

import torch
from torch import nn


def dropout(x, p: float, train: bool = False, generator=None):
    """x with each unit zeroed with probability p and the rest scaled by
    1 / (1 - p), in training; x itself otherwise or when p == 0."""
    if not train or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


class Dropout(nn.Module):
    """Holds p; `forward(x, train, generator)` is `dropout`."""

    def __init__(self, p: float = 0.0):
        super().__init__()
        self.p = p

    def forward(self, x, train: bool = False, generator=None):
        return dropout(x, self.p, train, generator)

    def extra_repr(self) -> str:
        return f"p={self.p}"
