"""3D-CNN encoder blocks, channels-last (B, X, Y, Z, C), eval and training.

Port of transmf_ad_tpu/nn/blocks.py (`ConvBNAct`, `SNet`, `SFCN`,
`global_avg_pool`, `tokens_from_volume`). A conv block runs its conv
without bias and folds the bias into the BatchNorm shift; the BN apply and
the activation (LeakyReLU in sNet, ReLU in SFCN and the baselines) then
fuse into the stage-end pool kernel:

  stage 1      stem kernel K3 (Cin = 1), then K4 max with (Z*C,) lane vectors
  stages 2, 3  F.conv3d, then K4 max with (C,) vectors
  stage 4      F.conv3d (3^3, then 1^3), then K4 mean with (C,) vectors

Blocks without a pool apply the affine + activation unfused, and so do the
blocks of ADVIT and Mnet, whose (1, 1, 2) and (p, p, 1) windows their
models pool with `F.max_pool3d`, as the JAX package pools them with
`nn.max_pool`. In training the
stem is kernel K5 (the conv plus its BatchNorm sums, backward K6) and the
pools' backward is K7.

A 3^3 body conv over at least `band_min_voxels` voxels (400,000 by default:
only the two stage-2 convs of a 182x218x182 input, at 91x109x91) takes the
band-conv kernel K8 (`ops/band_conv.py`; in training with its BatchNorm sums,
backward K8 and K9), and its stage-end max pool then takes the lane-vector
entry, as in the JAX package. Below the threshold the body convs stay
`F.conv3d` with its own autograd, where the JAX package leaves them to XLA.

`SNet(remat=True)` recomputes, in the backward, the forward of each block
whose intermediates are worth it (`_remat_worth_it`, the JAX package's
rule), through `torch.utils.checkpoint`: their conv output and activation
are not stored, only the block's input. The recompute reruns the block's
kernels (K5 or K8 with its sums, the BatchNorm statistics, K4); the
running statistics move once (`batchnorm.recomputing`).

Over the tensor-parallel 'model' axis (`parallel/tensor.py`) a block
whose conv is sharded computes the rank's output channels through the same
kernels (K3 / K5, K8, F.conv3d on the rank's rows of the weight), takes
their BatchNorm moments, affine, activation and pool on that slice, and
all-gathers the channels at the block's end: after the pool, whose output
is 8x smaller than the conv's.

Parameters carry the reference sNet's torch names (`conv1.0.weight`,
`conv1.1.running_mean`, ... `conv4.4.bias`), which
`transmf_ad_tpu.utils.torch_import.map_state_dict` reads.
"""

from __future__ import annotations

import contextlib
import functools
import math
import os

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.band_conv import band_conv3d, band_conv3d_stats
from ..ops.pool3d import (avg_pool3d_2x2_affine_act,
                          max_pool3d_2x2_affine_act,
                          max_pool3d_2x2_affine_act_bc)
from ..ops.stem import stem_conv, stem_conv_stats
from ..parallel.tensor import shard_of
from ..utils import tracing
from . import batchnorm
from .batchnorm import ManualBN, bn_affine_reference

# the negative slope of each activation (JAX's ConvBNAct `act`)
SLOPES = {"leaky_relu": 0.01, "relu": 0.0, "none": 1.0}
BAND_MIN_VOXELS = 400_000  # the JAX package's TRANSMF_BAND_CONV_MIN_VOX


def conv_bn_act(x, conv: nn.Conv3d, bn: ManualBN, pool=None,
                act: str = "leaky_relu", train: bool = False, bn_mask=None,
                *, band_min_voxels: int):
    """ConvBNAct: conv (bias-free) -> BN -> activation [-> 2^3 pool].

    x: (B, X, Y, Z, Cin) in the compute dtype; the conv weight is cast to
    it, and the conv's stride and padding are the module's (padding k // 2
    is JAX's "SAME" for the odd kernels here, 0 its "VALID"). pool: None,
    'max' or 'avg'. act: a key of `SLOPES`. train: BN takes batch
    statistics (the producer kernel's sums, or mask-weighted moments when
    `bn_mask` (B,) is given) and moves its running statistics.
    band_min_voxels: a 3^3 SAME stride-1 conv with Cin > 1 over at least
    this many voxels takes the band-conv kernel; the stem kernel takes a
    3^3 SAME stride-1 conv from one channel. A conv sharded over the model
    axis gives the rank's channels, gathered at the end."""
    slope = SLOPES[act]
    shard = shard_of(conv.weight)
    bias = conv.bias
    if shard is not None:
        x = shard.axis.copy_in(x)
        bias = shard.local(bias)
    with tracing.span("conv"):
        w = conv.weight.to(x.dtype)
        cube = (conv.kernel_size == (3, 3, 3) and conv.stride == (1, 1, 1)
                and conv.padding == (1, 1, 1))
        stem = x.shape[-1] == 1 and cube
        band = (not stem and cube
                and x.shape[1] * x.shape[2] * x.shape[3] >= band_min_voxels)
        stats = None
        if stem:
            # OIDHW (C, 1, 3, 3, 3) -> DHW-O (3, 3, 3, C)
            wk = w[:, 0].permute(1, 2, 3, 0).contiguous()
            if train:
                y, st = stem_conv_stats(x[..., 0], wk)
                stats = (st[0], st[1], y.numel() // y.shape[-1])
            else:
                y = stem_conv(x[..., 0], wk)
        elif band:
            # OIDHW (Cout, Cin, 3, 3, 3) -> DHWIO (3, 3, 3, Cin, Cout)
            wk = w.permute(2, 3, 4, 1, 0).contiguous()
            if train and bn_mask is None:
                y, st = band_conv3d_stats(x, wk)
                stats = (st[0], st[1], y.numel() // y.shape[-1])
            else:
                y = band_conv3d(x, wk)
        else:
            # a channels-last-3d view in and out: F.conv3d keeps the
            # layout, so the permutes around it are views, not copies
            wt = w.contiguous(memory_format=torch.channels_last_3d)
            y = F.conv3d(x.permute(0, 4, 1, 2, 3), wt, stride=conv.stride,
                         padding=conv.padding)
            y = y.permute(0, 2, 3, 4, 1).contiguous()
    if bn_mask is not None:
        stats = None  # the producer sums cover padded duplicates too
    with tracing.span("BatchNorm statistics"):
        scale, shift = bn(y, bias, train, stats, bn_mask, shard)
    if pool is None:
        with tracing.span("affine + activation"):
            out = bn_affine_reference(y, scale, shift, slope)
    else:
        with tracing.span("pool"):
            if (stem or band) and pool == "max":
                z = y.shape[3]
                out = max_pool3d_2x2_affine_act(y, scale.repeat(z),
                                                shift.repeat(z), slope)
            elif pool == "max":
                out = max_pool3d_2x2_affine_act_bc(y, scale, shift, slope)
            else:
                out = avg_pool3d_2x2_affine_act(y, scale, shift, slope)
    return out if shard is None else shard.gather(out, -1)


def max_pool_window(x, window):
    """torch MaxPool3d(window, window) (VALID, floor) of a channels-last
    (B, X, Y, Z, C) tensor: the windows JAX's baselines pool with
    `nn.max_pool`, which are XLA ops there, not Pallas kernels."""
    y = F.max_pool3d(x.permute(0, 4, 1, 2, 3), window, window)
    return y.permute(0, 2, 3, 4, 1)


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
# each block's span (`utils/tracing.py`), named by its conv slot
_BLOCK_SPANS = tuple(f"encoder {stage}.{cs}" for stage, cs, *_ in _PLAN)


def _remat_worth_it(shape, features, itemsize=2):
    """Whether recomputing a ConvBNAct block in the backward pays at this
    input shape (the JAX package's rule, nn/blocks.py:285-302): the block's
    intermediates, the conv output and the activation at the input's
    spatial size, 2 * prod(shape[:-1]) * features elements of `itemsize`
    bytes (2 whatever the compute dtype, as in the JAX package), must reach
    TRANSMF_REMAT_MIN_MB MiB (default 300): the block's input is stored
    either way, so small intermediates buy nothing. `shape` is the block's
    input on this rank, as JAX's rule sees one shard's. At batch 8,
    91x109x91 only the stem block qualifies; at batch 6, 182x218x182 blocks
    0, 1, 2 and 4 (5.5 GB, 693 MB, 1.39 GB, 336 MB; block 3 has 168)."""
    min_mb = float(os.environ.get("TRANSMF_REMAT_MIN_MB", "300"))
    inter = 2 * math.prod(shape[:-1]) * features * itemsize
    return inter >= min_mb * 2**20


def _remat_contexts(group):
    """`checkpoint`'s context_fn: nothing around the forward; around the
    recompute, the forward's process group and no running-statistics
    update (`batchnorm.recomputing`)."""
    return contextlib.nullcontext(), batchnorm.recomputing(group)


class SNet(nn.Module):
    """Per-modality 3D-CNN encoder: (B, X, Y, Z, 1) -> (B, X/16, Y/16, Z/16,
    dim); 91x109x91 gives the 5x6x5 = 150-token grid. remat: in training
    with autograd on, the blocks `_remat_worth_it` picks recompute their
    forward in the backward (the parameter names do not change)."""

    def __init__(self, dim: int = 128,
                 band_min_voxels: int = BAND_MIN_VOXELS,
                 remat: bool = False):
        super().__init__()
        self.band_min_voxels = band_min_voxels
        self.remat = remat
        q = dim // 4
        stages = {}
        for stage, cs, bs, (ci, co), k, _ in _PLAN:
            cin = ci * q if ci else 1
            slots = stages.setdefault(stage, nn.ModuleDict())
            slots[cs] = nn.Conv3d(cin, co * q, k, padding=k // 2)
            slots[bs] = ManualBN(co * q)
        for name, slots in stages.items():
            self.add_module(name, slots)

    def remat_blocks(self, shape):
        """Indices of the blocks that `remat` recomputes for an input of
        `shape` (B, X, Y, Z, 1), from the rule alone (no forward)."""
        q = self.conv1["0"].out_channels
        spatial, picked = list(shape[:-1]), []
        for i, (_, _, _, (ci, co), _, pool) in enumerate(_PLAN):
            cin = ci * q if ci else 1
            if _remat_worth_it((*spatial, cin), co * q):
                picked.append(i)
            if pool:
                spatial[1:] = [d // 2 for d in spatial[1:]]
        return picked

    def forward(self, x, train: bool = False, bn_mask=None):
        wrap = self.remat and train and torch.is_grad_enabled()
        for name, (stage, cs, bs, _, _, pool) in zip(_BLOCK_SPANS, _PLAN):
            slots = getattr(self, stage)
            block = functools.partial(
                conv_bn_act, conv=slots[cs], bn=slots[bs], pool=pool,
                train=train, bn_mask=bn_mask,
                band_min_voxels=self.band_min_voxels)
            with tracing.span(name):
                if wrap and _remat_worth_it(x.shape, slots[cs].out_channels):
                    # the update of the running statistics stays in the
                    # forward: the recompute skips it (`_remat_contexts`)
                    x = checkpoint(block, x, use_reentrant=False,
                                   preserve_rng_state=False,
                                   context_fn=functools.partial(
                                       _remat_contexts,
                                       batchnorm.sync_group()))
                else:
                    x = block(x)
        return x


class SFCN(nn.Module):
    """5-block fully-convolutional encoder (reference: models/networks.py:
    64-110, a library extra no model uses): four 3^3 SAME ConvBNAct blocks
    with ReLU and a 2^3 max pool, then a 1^3 ConvBNAct with ReLU. The
    first conv is the stem kernel's (K3, in training K5 with backward K6),
    the pools K4 / K7 at slope 0. Blocks are `blocks.{i}.{conv,bn}`."""

    def __init__(self, channels=(32, 64, 128, 128, 64)):
        super().__init__()
        blocks, cin = [], 1
        for i, ch in enumerate(channels):
            k = 3 if i < 4 else 1
            blocks.append(nn.ModuleDict({
                "conv": nn.Conv3d(cin, ch, k, padding=k // 2),
                "bn": ManualBN(ch)}))
            cin = ch
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x, train: bool = False, bn_mask=None):
        for i, blk in enumerate(self.blocks):
            x = conv_bn_act(x, blk["conv"], blk["bn"],
                            "max" if i < 4 else None, "relu", train, bn_mask,
                            band_min_voxels=BAND_MIN_VOXELS)
        return x


def global_avg_pool(x):
    """AdaptiveAvgPool3d(1) + flatten for channels-last maps -> (B, C)."""
    return x.float().mean(dim=(1, 2, 3)).to(x.dtype)


def tokens_from_volume(x):
    """(B, X, Y, Z, C) -> (B, X*Y*Z, C): tokens run x-y-z, channels last."""
    return x.reshape(x.shape[0], -1, x.shape[-1])
