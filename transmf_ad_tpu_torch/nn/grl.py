"""Gradient reversal layer: identity forward, -alpha * g backward.

Port of transmf_ad_tpu/nn/grl.py.
"""

from __future__ import annotations

import torch


class _RevGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, alpha):
        ctx.alpha = alpha
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -ctx.alpha * g, None


def revgrad(x: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    """Identity in the forward pass; scales the gradient by -alpha."""
    return _RevGrad.apply(x, alpha)
