"""BatchNorm for the port, eval mode.

Port of transmf_ad_tpu/nn/batchnorm.py. `ManualBN` is an affine factory: it
turns the running statistics into a per-channel float32 (scale, shift) with
the conv bias folded into the shift, so the conv runs bias-free and the
apply + activation fuses into the stage-end pool kernel. `BatchNormMasked`
normalises dense head features. Parameters and buffers carry torch
BatchNorm's names (weight, bias, running_mean, running_var). Training-mode
statistics are still to port.
"""

from __future__ import annotations

import torch
from torch import nn


class _RunningStats(nn.Module):
    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def _affine(self, bias=None):
        """float32 (scale, shift) with y * scale + shift == BN(y + bias)."""
        scale = self.weight.float() * torch.rsqrt(
            self.running_var.float() + self.eps)
        mean = self.running_mean.float()
        if bias is not None:
            mean = mean - bias.float()
        return scale, self.bias.float() - mean * scale

    def _check_eval(self):
        if self.training:
            raise NotImplementedError(
                "training-mode BatchNorm is not ported yet (ROADMAP.md Queue "
                "1 item 4); call .eval()")


class ManualBN(_RunningStats):
    """BatchNorm3d over a bias-free conv output, returned as an affine."""

    def forward(self, conv_bias=None):
        self._check_eval()
        return self._affine(conv_bias)


class BatchNormMasked(_RunningStats):
    """BatchNorm1d over (B, F) features: float32 math, cast back."""

    def forward(self, x):
        self._check_eval()
        scale, shift = self._affine()
        return (x.float() * scale + shift).to(x.dtype)


def bn_affine_reference(y, scale, shift, slope: float = 0.01):
    """Apply the ManualBN affine + LeakyReLU unfused (float32, rounded to
    y's dtype)."""
    z = y.float() * scale + shift
    return torch.where(z >= 0, z, slope * z).to(y.dtype)
