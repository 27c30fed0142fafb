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

Synced BatchNorm (the JAX package's `axis_name`): inside `synced(group)`
the batch moments (sum, sum of squares and, under a mask, the count) are
all-reduced over the ranks of a torch.distributed process group, so every
rank normalises with the statistics of the global batch; without a mask
the count is the local one times the world size. The all-reduce is
differentiable with psum's transpose: its backward all-reduces the
cotangent. A block that `nn/blocks.py` checkpoints recomputes its forward
in the backward inside `recomputing(group)`: the same group, and no second
update of the running statistics (the forward made it; the JAX package's
`nn.remat` likewise drops the recompute's `batch_stats`).

Behind a conv sharded over the tensor-parallel 'model' axis, `ManualBN`
takes the conv's `Shard`: the moments are those of the rank's channels
(synced over the data group alone), the scale and shift are the rank's
rows (`Shard.local`), and the new batch mean and variance are all-gathered
over the model group before they enter the running statistics, which stay
whole and the same on every rank.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist
from torch import nn

from ..parallel.distributed import psum

_MOMENTUM = 0.9  # flax convention: new = m * old + (1 - m) * batch

# the process group the batch moments are all-reduced over (None: this
# process's batch alone), and whether a checkpointed block is being
# recomputed. Module state, not thread-local: a CUDA backward, and with it
# the recompute, runs on autograd's device thread while the caller waits.
_SYNC = {"group": None, "recompute": False}


@contextlib.contextmanager
def _set(**kw):
    prev = dict(_SYNC)
    _SYNC.update(kw)
    try:
        yield
    finally:
        _SYNC.update(prev)


def synced(group):
    """Context: BatchNorm batch moments over every rank of `group`."""
    return _set(group=group)


def recomputing(group):
    """Context of a checkpointed block's recompute: the group its forward
    ran under, and the running statistics left as they are."""
    return _set(group=group, recompute=True)


def sync_group():
    """The process group of the enclosing `synced`, or None."""
    return _SYNC["group"]


def _global(s, ss, n):
    """(s, ss, n) summed over the ranks of the synced group: one
    differentiable all-reduce of s, ss and, when it is a tensor (a masked
    count), n; an int count is the same on every rank."""
    group = _SYNC["group"]
    if group is None:
        return s, ss, n
    counted = isinstance(n, torch.Tensor)
    parts = [s, ss] + ([n.reshape(1).float()] if counted else [])
    total = psum(torch.cat(parts), group)
    c = s.shape[0]
    s, ss = total[:c], total[c:2 * c]
    n = total[2 * c] if counted else n * dist.get_world_size(group)
    return s, ss, n


class _RunningStats(nn.Module):
    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def _update(self, mean, var, n, shard=None):
        """Running averages from the batch mean and BIASED variance over n
        samples (running_var takes the unbiased one); a `shard`'s rows are
        gathered whole first. Skipped while a checkpointed block recomputes
        its forward."""
        if _SYNC["recompute"]:
            return
        with torch.no_grad():
            if shard is not None:
                mean, var = (shard.gather(t.detach(), 0) for t in (mean, var))
            var_u = var * (n / max(n - 1, 1) if isinstance(n, (int, float))
                           else n / torch.clamp(n - 1, min=1))
            m = _MOMENTUM
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var_u)

    def _normalizer(self, mean, var, shard=None):
        w, b = ((self.weight, self.bias) if shard is None
                else (shard.local(self.weight), shard.local(self.bias)))
        scale = w.float() * torch.rsqrt(var + self.eps)
        return scale, b.float() - mean * scale


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
                stats=None, mask=None, shard=None):
        """float32 (scale, shift) with y * scale + shift == BN(y + bias).

        train: batch moments of y (B, ..., C), or the producer sums
        `stats` = (sum, sumsq, n) of y, or mask-weighted moments of y, and
        the running statistics move. `stats` and `mask` are mutually
        exclusive: producer sums cover every sample of a padded batch.
        shard: the sharded conv's `Shard`; y and `conv_bias` are the rank's
        channels, and so are the scale and shift returned."""
        rm, rv = self.running_mean, self.running_var
        if shard is not None:
            rm, rv = shard.rows(rm, 0), shard.rows(rv, 0)
        b = (torch.zeros_like(rm) if conv_bias is None
             else conv_bias.float())
        if not train:
            return self._normalizer(rm.float() - b, rv.float(), shard)
        if stats is not None and mask is not None:
            raise ValueError("ManualBN: `stats` and `mask` are mutually "
                             "exclusive: producer-kernel sums cover the whole "
                             "padded batch and cannot be mask-corrected")
        s, ss, n = _global(*(stats if stats is not None
                             else _moments(y, mask)))
        mean0 = s / n  # mean of the bias-free output
        var = ss / n - mean0 * mean0
        mean = mean0 + b
        self._update(mean, var, n, shard)
        # shift = beta - (mean - b) * scale keeps the JAX algebra, so the
        # conv bias gets its (zero up to rounding) gradient the same way
        return self._normalizer(mean - b, var, shard)


class BatchNormMasked(_RunningStats):
    """BatchNorm1d over (B, F) features: float32 math, cast back."""

    def forward(self, x, train: bool = False, mask=None):
        if train:
            s, ss, n = _global(*_moments(x, mask))
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
