"""MiSePyNet / Mnet baseline: a slice-wise multi-view CNN.

Port of transmf_ad_tpu/models/misepynet.py (reference: models/MiSePyNet.py).
Per modality, three anatomical views (axial, coronal, sagittal
permutations of the volume); each goes through a slice CNN (three parallel
branches collapsing the last spatial axis with VALID convs of kernel
(1, 1, L), (1, 1, ceil(L/2)) x 2 and (1, 1, ceil(L/3)) x 3, 8 channels,
ReLU) and then the spatial stack the reference drives (its `conv1`:
Conv (k, k, 1) stride 2 -> MaxPool (p, p, 1) -> Conv (k, k, 1) -> MaxPool
(p, p, 1) -> Conv 1^3 to 64 channels), one set of weights applied to the
three branches and summed; the views' maps are flattened channel-major
(torch's .view of NCDHW), 320 features a modality at 91 x 109 x 91. `Mnet`
concatenates both modalities into the head Linear -> BN -> ReLU -> Dropout
(0.5), twice (512, 64), -> Linear(64, 2).

No TPU kernel is on this path, in the JAX package or here: the convs are
`F.conv3d` and the windows `F.max_pool3d`. Names follow the reference:
`{mri,pet}.slice_cnn_{view}.conv{1,2,3}.{slot}`,
`{mri,pet}.spatial_cnn_{view}.conv1.{0,1,4,5,8,9}` and `fc.{0,1,4,5,8}`.
The JAX modules size the head from their first input; a torch module needs
the volume's `input_shape` when it is built.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..nn.batchnorm import ManualBN
from ..nn.blocks import BAND_MIN_VOXELS, conv_bn_act, max_pool_window
from .transmf import _FusionHead

# each view's permutation of (B, X, Y, Z, C); the slice CNN collapses the
# permuted tensor's last spatial axis
VIEWS = (("axial", (0, 1, 2, 3, 4)), ("col", (0, 1, 3, 2, 4)),
         ("sag", (0, 3, 2, 1, 4)))


def _run(stack, slots, x, train, bn_mask, pool=None):
    """ConvBNAct blocks (ReLU) over (conv slot, BN slot) pairs, with a
    (pool, pool, 1) max pool after every block but the last."""
    for i, (cs, bs) in enumerate(slots):
        x = conv_bn_act(x, stack[cs], stack[bs], act="relu", train=train,
                        bn_mask=bn_mask, band_min_voxels=BAND_MIN_VOXELS)
        if pool and i < len(slots) - 1:
            x = max_pool_window(x, (pool, pool, 1))
    return x


def _conv_bn(slots):
    """A ModuleDict of reference slots: {conv slot: Conv3d, BN slot:
    ManualBN} from (conv slot, BN slot, Conv3d) triples."""
    out = {}
    for cs, bs, conv in slots:
        out[cs], out[bs] = conv, ManualBN(conv.out_channels)
    return nn.ModuleDict(out)


class SliceCNN(nn.Module):
    """Three parallel branches collapsing the last spatial axis (length L)."""

    def __init__(self, length: int):
        super().__init__()
        k2, k3 = (length + 1) // 2, (length + 2) // 3
        self.depths = (1, length - 2 * (k2 - 1), length - 3 * (k3 - 1))
        self.conv1 = _conv_bn([("0", "1", nn.Conv3d(1, 8, (1, 1, length)))])
        self.conv2 = _conv_bn([("0", "1", nn.Conv3d(1, 8, (1, 1, k2))),
                               ("3", "4", nn.Conv3d(8, 8, (1, 1, k2)))])
        self.conv3 = _conv_bn([("0", "1", nn.Conv3d(1, 8, (1, 1, k3))),
                               ("3", "4", nn.Conv3d(8, 8, (1, 1, k3))),
                               ("6", "7", nn.Conv3d(8, 8, (1, 1, k3)))])

    def forward(self, x, train: bool = False, bn_mask=None):
        return (_run(self.conv1, (("0", "1"),), x, train, bn_mask),
                _run(self.conv2, (("0", "1"), ("3", "4")), x, train, bn_mask),
                _run(self.conv3, (("0", "1"), ("3", "4"), ("6", "7")), x,
                     train, bn_mask))


class SpatialCNN(nn.Module):
    """The driven spatial stack, shared by the three branches and summed.
    kernel / pool: 11 / 3 at the reference's (91, 109)-class planes."""

    def __init__(self, kernel: int = 11, pool: int = 3):
        super().__init__()
        self.pool = pool
        self.conv1 = _conv_bn([
            ("0", "1", nn.Conv3d(8, 16, (kernel, kernel, 1), stride=2)),
            ("4", "5", nn.Conv3d(16, 32, (kernel, kernel, 1))),
            ("8", "9", nn.Conv3d(32, 64, 1))])

    def forward(self, s1, s2, s3, train: bool = False, bn_mask=None):
        slots = (("0", "1"), ("4", "5"), ("8", "9"))
        return sum(_run(self.conv1, slots, s, train, bn_mask, self.pool)
                   for s in (s1, s2, s3))


def _spatial_size(n: int, kernel: int, pool: int) -> int:
    """One in-plane side through the spatial stack."""
    n = (n - kernel) // 2 + 1
    return (n // pool - kernel + 1) // pool


class MiSePyNet(nn.Module):
    """Three-view slice + spatial encoder: (B, X, Y, Z, 1) -> (B,
    `features`), 320 at (91, 109, 91) with kernel 11 and pool 3."""

    def __init__(self, input_shape=(91, 109, 91), spatial_kernel: int = 11,
                 spatial_pool: int = 3):
        super().__init__()
        self.features = 0
        for name, perm in VIEWS:
            a, b, length = (input_shape[i - 1] for i in perm[1:4])
            slc = SliceCNN(length)
            self.add_module(f"slice_cnn_{name}", slc)
            self.add_module(f"spatial_cnn_{name}",
                            SpatialCNN(spatial_kernel, spatial_pool))
            # the branch maps broadcast in the sum; a stride-2 depth
            depth = (max(slc.depths) - 1) // 2 + 1
            sides = [_spatial_size(n, spatial_kernel, spatial_pool)
                     for n in (a, b)]
            if min(sides) < 1:
                raise ValueError(
                    f"MiSePyNet: a {input_shape} volume leaves no voxel in "
                    f"the {name} view after the spatial stack (kernel "
                    f"{spatial_kernel}, pool {spatial_pool})")
            self.features += 64 * depth * math.prod(sides)

    def forward(self, img, train: bool = False, bn_mask=None):
        feats = []
        for name, perm in VIEWS:
            s = getattr(self, f"slice_cnn_{name}")(img.permute(perm), train,
                                                   bn_mask)
            out = getattr(self, f"spatial_cnn_{name}")(*s, train, bn_mask)
            # channel-major, like torch's .view of NCDHW, so the head's
            # weights map 1:1 to the reference's
            feats.append(out.permute(0, 4, 1, 2, 3).reshape(out.shape[0], -1))
        return torch.cat(feats, dim=-1)


class Mnet(nn.Module):
    """Dual-modality MiSePyNet + the BatchNorm MLP head -> logits.
    input_shape: the padded (X, Y, Z) volume, (91, 109, 91) in the
    reference driver; head_dropout: the head's (the reference's 0.5)."""

    def __init__(self, input_shape=(91, 109, 91), spatial_kernel: int = 11,
                 spatial_pool: int = 3, head_dropout: float = 0.5):
        super().__init__()
        kw = dict(input_shape=input_shape, spatial_kernel=spatial_kernel,
                  spatial_pool=spatial_pool)
        self.mri = MiSePyNet(**kw)
        self.pet = MiSePyNet(**kw)
        self.fc = _FusionHead(2 * self.mri.features, head_dropout)

    def forward(self, mri, pet, train: bool = False, bn_mask=None,
                generator=None):
        """mri, pet: (B, X, Y, Z, 1) -> logits (B, 2)."""
        x = torch.cat([self.mri(mri, train, bn_mask),
                       self.pet(pet, train, bn_mask)], dim=-1)
        return self.fc(x, train, bn_mask, generator)
