"""3D-CNN encoder blocks, channels-last (B, X, Y, Z, C), eval and training.

Port of transmf_ad_tpu/nn/blocks.py (`ConvBNAct`, `SNet`,
`global_avg_pool`, `tokens_from_volume`). A conv block runs its conv
without bias and folds the bias into the BatchNorm shift; the BN apply and
LeakyReLU then fuse into the stage-end pool kernel:

  stage 1      stem kernel K3 (Cin = 1), then K4 max with (Z*C,) lane vectors
  stages 2, 3  F.conv3d, then K4 max with (C,) vectors
  stage 4      F.conv3d (3^3, then 1^3), then K4 mean with (C,) vectors

Blocks without a pool apply the affine + LeakyReLU unfused. The body convs
stay `F.conv3d` with its own autograd: the JAX package leaves them to XLA at
these shapes. In training the stem is kernel K5 (the conv plus its BatchNorm
sums, backward K6) and the pools' backward is K7.

Parameters carry the reference sNet's torch names (`conv1.0.weight`,
`conv1.1.running_mean`, ... `conv4.4.bias`), which
`transmf_ad_tpu.utils.torch_import.map_state_dict` reads.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.pool3d import (avg_pool3d_2x2_affine_act,
                          max_pool3d_2x2_affine_act,
                          max_pool3d_2x2_affine_act_bc)
from ..ops.stem import stem_conv, stem_conv_stats
from .batchnorm import ManualBN, bn_affine_reference

_SLOPE = 0.01  # LeakyReLU negative slope (reference sNet)


def conv_bn_act(x, conv: nn.Conv3d, bn: ManualBN, pool=None,
                slope: float = _SLOPE, train: bool = False, bn_mask=None):
    """ConvBNAct: conv (bias-free) -> BN -> LeakyReLU [-> 2^3 pool].

    x: (B, X, Y, Z, Cin) in the compute dtype; the conv weight is cast to
    it. pool: None, 'max' or 'avg'. train: BN takes batch statistics (the
    stem kernel's sums, or mask-weighted moments when `bn_mask` (B,) is
    given) and moves its running statistics."""
    w = conv.weight.to(x.dtype)
    stem = x.shape[-1] == 1 and conv.kernel_size == (3, 3, 3)
    stats = None
    if stem:
        # OIDHW (C, 1, 3, 3, 3) -> DHW-O (3, 3, 3, C)
        wk = w[:, 0].permute(1, 2, 3, 0).contiguous()
        if train:
            y, st = stem_conv_stats(x[..., 0], wk)
            stats = (st[0], st[1], y.numel() // y.shape[-1])
        else:
            y = stem_conv(x[..., 0], wk)
    else:
        # a channels-last-3d view in and out: F.conv3d keeps the layout, so
        # the permutes around it are views, not copies
        wt = w.contiguous(memory_format=torch.channels_last_3d)
        y = F.conv3d(x.permute(0, 4, 1, 2, 3), wt, padding=conv.padding)
        y = y.permute(0, 2, 3, 4, 1).contiguous()
    if bn_mask is not None:
        stats = None  # the producer sums cover padded duplicates too
    scale, shift = bn(y, conv.bias, train, stats, bn_mask)
    if stem and pool == "max":
        z = y.shape[3]
        return max_pool3d_2x2_affine_act(y, scale.repeat(z), shift.repeat(z),
                                         slope)
    if pool == "max":
        return max_pool3d_2x2_affine_act_bc(y, scale, shift, slope)
    if pool == "avg":
        return avg_pool3d_2x2_affine_act(y, scale, shift, slope)
    return bn_affine_reference(y, scale, shift, slope)


# (stage, conv slot, BN slot) of each block in the reference sNet, and the
# block's (input width, output width) as multiples of dim / 4, kernel, pool
_PLAN = (
    ("conv1", "0", "1", (0, 1), 3, "max"),
    ("conv2", "0", "1", (1, 1), 3, None),
    ("conv2", "3", "4", (1, 2), 3, "max"),
    ("conv3", "0", "1", (2, 2), 3, None),
    ("conv3", "3", "4", (2, 4), 3, "max"),
    ("conv4", "0", "1", (4, 8), 3, None),
    ("conv4", "3", "4", (8, 4), 1, "avg"),
)


class SNet(nn.Module):
    """Per-modality 3D-CNN encoder: (B, X, Y, Z, 1) -> (B, X/16, Y/16, Z/16,
    dim); 91x109x91 gives the 5x6x5 = 150-token grid."""

    def __init__(self, dim: int = 128):
        super().__init__()
        q = dim // 4
        stages = {}
        for stage, cs, bs, (ci, co), k, _ in _PLAN:
            cin = ci * q if ci else 1
            slots = stages.setdefault(stage, nn.ModuleDict())
            slots[cs] = nn.Conv3d(cin, co * q, k, padding=k // 2)
            slots[bs] = ManualBN(co * q)
        for name, slots in stages.items():
            self.add_module(name, slots)

    def forward(self, x, train: bool = False, bn_mask=None):
        for stage, cs, bs, _, _, pool in _PLAN:
            slots = getattr(self, stage)
            x = conv_bn_act(x, slots[cs], slots[bs], pool, train=train,
                            bn_mask=bn_mask)
        return x


def global_avg_pool(x):
    """AdaptiveAvgPool3d(1) + flatten for channels-last maps -> (B, C)."""
    return x.float().mean(dim=(1, 2, 3)).to(x.dtype)


def tokens_from_volume(x):
    """(B, X, Y, Z, C) -> (B, X*Y*Z, C): tokens run x-y-z, channels last."""
    return x.reshape(x.shape[0], -1, x.shape[-1])
