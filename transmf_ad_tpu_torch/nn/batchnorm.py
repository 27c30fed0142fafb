"""BatchNorm for the port, eval and training mode.

Port of transmf_ad_tpu/nn/batchnorm.py. `ManualBN` is an affine factory: it
turns statistics into a per-channel float32 (scale, shift) with the conv bias
folded into the shift, so the conv runs bias-free and the apply + activation
fuses into the stage-end pool kernel. `BatchNormMasked` normalises dense head
features. Parameters and buffers carry torch BatchNorm's names (weight, bias,
running_mean, running_var).

Training mode follows torch BatchNorm (and the JAX package): the biased batch
variance normalises, the unbiased one (n / (n - 1)) enters running_var,
momentum 0.1 in torch's convention (flax's 0.9), eps 1e-5, statistics in
float32. The batch moments come from producer sums (`stats`, e.g. the stem
kernel's), from a 0/1 per-sample `mask` (so a duplicate-padded batch gives the
statistics of its real samples), or from the tensor itself. The mode is the
`train` argument, as in the JAX package; nn.Module.training is not read.
"""

from __future__ import annotations

import math

import torch
from torch import nn

_MOMENTUM = 0.9  # flax convention: new = m * old + (1 - m) * batch


class _RunningStats(nn.Module):
    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def _update(self, mean, var, n):
        """Running averages from the batch mean and BIASED variance over n
        samples (running_var takes the unbiased one)."""
        with torch.no_grad():
            var_u = var * (n / max(n - 1, 1) if isinstance(n, (int, float))
                           else n / torch.clamp(n - 1, min=1))
            m = _MOMENTUM
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var_u)

    def _normalizer(self, mean, var):
        scale = self.weight.float() * torch.rsqrt(var + self.eps)
        return scale, self.bias.float() - mean * scale


def _moments(y, mask):
    """float32 (sum, sum of squares) over every axis but the last, and the
    count; with a (B,) mask, samples are weighted by it."""
    yf = y.float()
    if mask is None:
        axes = tuple(range(y.dim() - 1))
        return yf.sum(dim=axes), (yf * yf).sum(dim=axes), y.numel() // y.shape[-1]
    w = mask.float()
    spatial = tuple(range(1, y.dim() - 1))
    per_s = yf.sum(dim=spatial) if spatial else yf
    per_ss = (yf * yf).sum(dim=spatial) if spatial else yf * yf
    n = w.sum() * math.prod(y.shape[1:-1])
    return (per_s * w[:, None]).sum(dim=0), (per_ss * w[:, None]).sum(dim=0), n


class ManualBN(_RunningStats):
    """BatchNorm3d over a bias-free conv output, returned as an affine."""

    def forward(self, y=None, conv_bias=None, train: bool = False,
                stats=None, mask=None):
        """float32 (scale, shift) with y * scale + shift == BN(y + bias).

        train: batch moments of y (B, ..., C), or the producer sums
        `stats` = (sum, sumsq, n) of y, or mask-weighted moments of y, and
        the running statistics move. `stats` and `mask` are mutually
        exclusive: producer sums cover every sample of a padded batch."""
        b = (torch.zeros_like(self.running_mean) if conv_bias is None
             else conv_bias.float())
        if not train:
            return self._normalizer(self.running_mean.float() - b,
                                    self.running_var.float())
        if stats is not None and mask is not None:
            raise ValueError("ManualBN: `stats` and `mask` are mutually "
                             "exclusive: producer-kernel sums cover the whole "
                             "padded batch and cannot be mask-corrected")
        s, ss, n = stats if stats is not None else _moments(y, mask)
        mean0 = s / n  # mean of the bias-free output
        var = ss / n - mean0 * mean0
        mean = mean0 + b
        self._update(mean, var, n)
        # shift = beta - (mean - b) * scale keeps the JAX algebra, so the
        # conv bias gets its (zero up to rounding) gradient the same way
        return self._normalizer(mean - b, var)


class BatchNormMasked(_RunningStats):
    """BatchNorm1d over (B, F) features: float32 math, cast back."""

    def forward(self, x, train: bool = False, mask=None):
        if train:
            s, ss, n = _moments(x, mask)
            mean = s / n
            var = ss / n - mean * mean
            self._update(mean, var, n)
        else:
            mean, var = self.running_mean.float(), self.running_var.float()
        scale, shift = self._normalizer(mean, var)
        return (x.float() * scale + shift).to(x.dtype)


def bn_affine_reference(y, scale, shift, slope: float = 0.01):
    """Apply the ManualBN affine + LeakyReLU unfused (float32, rounded to
    y's dtype)."""
    z = y.float() * scale + shift
    return torch.where(z >= 0, z, slope * z).to(y.dtype)
