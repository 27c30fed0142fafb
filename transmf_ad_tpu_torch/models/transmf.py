"""The task models: `ModelAd`, `ModelTransformer`, `ModelTransformerRes`,
`ModelCNN`, `ModelCNNAd` and `ModelSingle`.

Port of transmf_ad_tpu/models/transmf.py (`_MLPHead`, `_FusionHead`,
`_Discriminator` and six models). `ModelAd`, the paper model: dual sNet
encoders, a gradient-reversal discriminator on the pooled features,
cross-modal transformer fusion and a 4*dim pooling head -> (logits, d_mri,
d_pet).
`ModelTransformer` is the same without the discriminator -> logits.
`ModelTransformerRes` fuses with `CrossTransformer` (each stream attends
over both), adds the encoder tokens back, averages each stream over its
tokens and classifies with a BatchNorm-less head -> logits.
`ModelCNN` fuses late: each encoder's map averaged over space, the two
vectors concatenated, an MLP head -> logits; `ModelCNNAd` adds
`ModelAd`'s discriminator on those vectors -> (logits, d_mri, d_pet).
`ModelSingle` is one sNet on the MRI alone, averaged over space, and an MLP
head -> logits.
Module names follow the reference torch models (`mri_cnn`, `pet_cnn`,
`D.{0,1,3}`, `fuse_transformer`, `fc_cls.{0,1,4,5,8}`, or `fc_cls.{0,3,6}`
without BatchNorm, `fc.{0,2}` / `fc_cls.{0,2}` for the MLP heads, and
`cnn` for ModelSingle's encoder).

Volumes are channels-last (B, X, Y, Z, 1); the whole forward computes in
the volumes' dtype with float32 parameters. `train=True` takes BatchNorm
batch statistics (weighted by `bn_mask` when given), moves the running
statistics, and applies dropout drawn from `generator`. `remat=True`
recomputes the costly encoder blocks in the backward (`nn/blocks.py::SNet`),
as the JAX models' `remat` field does.
"""

from __future__ import annotations

from torch import nn

import torch

from ..nn.attention import CrossTransformer, CrossTransformerModAvg, Linear
from ..nn.batchnorm import BatchNormMasked
from ..nn.blocks import (BAND_MIN_VOXELS, SNet, global_avg_pool,
                         tokens_from_volume)
from ..nn.dropout import Dropout
from ..nn.grl import revgrad
from ..utils import tracing


class _MLPHead(nn.Sequential):
    """Linear -> ReLU -> Linear(hidden, 2) classifier head (reference:
    mymodel.py:20,50,150)."""

    def __init__(self, in_features: int, hidden: int):
        super().__init__(Linear(in_features, hidden), nn.ReLU(),
                         Linear(hidden, 2))


class _FusionHead(nn.Sequential):
    """Linear -> BN -> ReLU -> Dropout, twice (512, 64), -> Linear(64, 2);
    without the BN layers (and their slots) when use_batchnorm=False."""

    def __init__(self, in_features: int, drop_rate: float = 0.5,
                 use_batchnorm: bool = True):
        layers, fan_in = [], in_features
        for width in (512, 64):
            layers.append(Linear(fan_in, width))
            if use_batchnorm:
                layers.append(BatchNormMasked(width))
            layers += [nn.ReLU(), Dropout(drop_rate)]
            fan_in = width
        super().__init__(*layers, Linear(fan_in, 2))

    def forward(self, x, train: bool = False, bn_mask=None, generator=None):
        for layer in self:
            if isinstance(layer, BatchNormMasked):
                x = layer(x, train, bn_mask)
            elif isinstance(layer, Dropout):
                x = layer(x, train, generator)
            else:
                x = layer(x)
        return x


class _Discriminator(nn.Sequential):
    """Modality discriminator: dim -> 128 -> BN -> ReLU -> 2."""

    def __init__(self, dim: int):
        super().__init__(Linear(dim, 128), BatchNormMasked(128), nn.ReLU(),
                         Linear(128, 2))

    def forward(self, x, train: bool = False, bn_mask=None):
        lin, bn, relu, out = self
        return out(relu(bn(lin(x), train, bn_mask)))


class ModelAd(nn.Module):
    """The paper model (reference: mymodel.py:182-222)."""

    def __init__(self, dim: int = 128, depth: int = 3, heads: int = 4,
                 dim_head: int = 32, mlp_dim: int = 512, dropout: float = 0.0,
                 grl_alpha: float = 2.0, head_dropout: float = 0.5,
                 band_min_voxels: int = BAND_MIN_VOXELS,
                 remat: bool = False):
        super().__init__()
        self.grl_alpha = grl_alpha
        self.mri_cnn = SNet(dim, band_min_voxels, remat)
        self.pet_cnn = SNet(dim, band_min_voxels, remat)
        self.D = _Discriminator(dim)
        self.fuse_transformer = CrossTransformerModAvg(
            dim, depth, heads, dim_head, mlp_dim, dropout)
        self.fc_cls = _FusionHead(4 * dim, head_dropout)

    def forward(self, mri, pet, train: bool = False, bn_mask=None,
                generator=None):
        """mri, pet: (B, X, Y, Z, 1) -> (logits, d_mri, d_pet), each (B, 2).
        bn_mask: optional (B,) 0/1 weights of the BatchNorm batch moments;
        generator: the torch.Generator dropout draws from in training."""
        mri_feat = self.mri_cnn(mri, train, bn_mask)
        pet_feat = self.pet_cnn(pet, train, bn_mask)
        with tracing.span("D"):
            d_mri = self.D(revgrad(global_avg_pool(mri_feat),
                                   self.grl_alpha), train, bn_mask)
            d_pet = self.D(revgrad(global_avg_pool(pet_feat),
                                   self.grl_alpha), train, bn_mask)
        with tracing.span("fuse_transformer"):
            fused = self.fuse_transformer(tokens_from_volume(mri_feat),
                                          tokens_from_volume(pet_feat),
                                          train, generator)
        with tracing.span("fc_cls"):
            logits = self.fc_cls(fused, train, bn_mask, generator)
        return logits, d_mri, d_pet


class ModelTransformer(nn.Module):
    """Cross-modal transformer fusion without the adversarial branch
    (reference: mymodel.py:69-98): `ModelAd`'s encoders, fusion and head,
    -> logits."""

    def __init__(self, dim: int = 128, depth: int = 3, heads: int = 4,
                 dim_head: int = 32, mlp_dim: int = 512, dropout: float = 0.0,
                 head_dropout: float = 0.5,
                 band_min_voxels: int = BAND_MIN_VOXELS,
                 remat: bool = False):
        super().__init__()
        self.mri_cnn = SNet(dim, band_min_voxels, remat)
        self.pet_cnn = SNet(dim, band_min_voxels, remat)
        self.fuse_transformer = CrossTransformerModAvg(
            dim, depth, heads, dim_head, mlp_dim, dropout)
        self.fc_cls = _FusionHead(4 * dim, head_dropout)

    def forward(self, mri, pet, train: bool = False, bn_mask=None,
                generator=None):
        """mri, pet: (B, X, Y, Z, 1) -> logits (B, 2)."""
        mri_tok = tokens_from_volume(self.mri_cnn(mri, train, bn_mask))
        pet_tok = tokens_from_volume(self.pet_cnn(pet, train, bn_mask))
        with tracing.span("fuse_transformer"):
            fused = self.fuse_transformer(mri_tok, pet_tok, train, generator)
        with tracing.span("fc_cls"):
            return self.fc_cls(fused, train, bn_mask, generator)


class ModelTransformerRes(nn.Module):
    """`CrossTransformer` fusion over the joint context, an outer residual
    to the encoder tokens, the mean over each stream's tokens and a
    BatchNorm-less head (reference: mymodel.py:101-141) -> logits."""

    def __init__(self, dim: int = 128, depth: int = 3, heads: int = 4,
                 dim_head: int = 32, mlp_dim: int = 512, dropout: float = 0.0,
                 head_dropout: float = 0.5,
                 band_min_voxels: int = BAND_MIN_VOXELS,
                 remat: bool = False):
        super().__init__()
        self.mri_cnn = SNet(dim, band_min_voxels, remat)
        self.pet_cnn = SNet(dim, band_min_voxels, remat)
        self.fuse_transformer = CrossTransformer(dim, depth, heads, dim_head,
                                                 mlp_dim, dropout)
        self.fc_cls = _FusionHead(2 * dim, head_dropout, use_batchnorm=False)

    def forward(self, mri, pet, train: bool = False, bn_mask=None,
                generator=None):
        """mri, pet: (B, X, Y, Z, 1) -> logits (B, 2)."""
        mri_tok = tokens_from_volume(self.mri_cnn(mri, train, bn_mask))
        pet_tok = tokens_from_volume(self.pet_cnn(pet, train, bn_mask))
        with tracing.span("fuse_transformer"):
            mri_f, pet_f = self.fuse_transformer(mri_tok, pet_tok, train,
                                                 generator)
        with tracing.span("fc_cls"):
            pooled = torch.cat([(mri_f + mri_tok).mean(dim=1),
                                (pet_f + pet_tok).mean(dim=1)], dim=-1)
            return self.fc_cls(pooled, train, bn_mask, generator)


class ModelCNN(nn.Module):
    """Dual-branch CNN, late fusion (reference: mymodel.py:40-66): two
    sNets, each averaged over space, concatenated, MLP 2*dim -> 128 -> 2
    -> logits."""

    def __init__(self, dim: int = 128,
                 band_min_voxels: int = BAND_MIN_VOXELS,
                 remat: bool = False):
        super().__init__()
        self.mri_cnn = SNet(dim, band_min_voxels, remat)
        self.pet_cnn = SNet(dim, band_min_voxels, remat)
        self.fc = _MLPHead(2 * dim, 128)

    def forward(self, mri, pet, train: bool = False, bn_mask=None,
                generator=None):
        """mri, pet: (B, X, Y, Z, 1) -> logits (B, 2). The model has no
        dropout; `generator` is taken for the train step's sake."""
        fused = torch.cat(
            [global_avg_pool(self.mri_cnn(mri, train, bn_mask)),
             global_avg_pool(self.pet_cnn(pet, train, bn_mask))], dim=-1)
        return self.fc(fused)


class ModelSingle(nn.Module):
    """Single-modality classifier (reference: mymodel.py:13-37): an sNet,
    averaged over space, MLP dim -> 64 -> 2 -> logits."""

    def __init__(self, dim: int = 128,
                 band_min_voxels: int = BAND_MIN_VOXELS,
                 remat: bool = False):
        super().__init__()
        self.cnn = SNet(dim, band_min_voxels, remat)
        self.fc = _MLPHead(dim, 64)

    def forward(self, img, train: bool = False, bn_mask=None,
                generator=None):
        """img: (B, X, Y, Z, 1) -> logits (B, 2). The model has no dropout;
        `generator` is taken for the train step's sake."""
        return self.fc(global_avg_pool(self.cnn(img, train, bn_mask)))


class ModelCNNAd(nn.Module):
    """`ModelCNN` with the gradient-reversal discriminator on the pooled
    vectors, shared by the modalities (reference: mymodel.py:144-179)
    -> (logits, d_mri, d_pet)."""

    def __init__(self, dim: int = 128, grl_alpha: float = 2.0,
                 band_min_voxels: int = BAND_MIN_VOXELS,
                 remat: bool = False):
        super().__init__()
        self.grl_alpha = grl_alpha
        self.mri_cnn = SNet(dim, band_min_voxels, remat)
        self.pet_cnn = SNet(dim, band_min_voxels, remat)
        self.D = _Discriminator(dim)
        self.fc_cls = _MLPHead(2 * dim, 128)

    def forward(self, mri, pet, train: bool = False, bn_mask=None,
                generator=None):
        """mri, pet: (B, X, Y, Z, 1) -> (logits, d_mri, d_pet), each (B, 2).
        The model has no dropout; `generator` is taken for the train
        step's sake."""
        mri_vec = global_avg_pool(self.mri_cnn(mri, train, bn_mask))
        pet_vec = global_avg_pool(self.pet_cnn(pet, train, bn_mask))
        with tracing.span("D"):
            d_mri = self.D(revgrad(mri_vec, self.grl_alpha), train, bn_mask)
            d_pet = self.D(revgrad(pet_vec, self.grl_alpha), train, bn_mask)
        with tracing.span("fc_cls"):
            logits = self.fc_cls(torch.cat([mri_vec, pet_vec], dim=-1))
        return logits, d_mri, d_pet
