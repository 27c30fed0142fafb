"""The paper model `ModelAd`.

Port of transmf_ad_tpu/models/transmf.py (`_FusionHead`, `_Discriminator`,
`ModelAd`): dual sNet encoders, a gradient-reversal discriminator on the
pooled features, cross-modal transformer fusion and a 4*dim pooling head ->
(logits, d_mri, d_pet). Module names follow the reference torch model
(`mri_cnn`, `pet_cnn`, `D.{0,1,3}`, `fuse_transformer`,
`fc_cls.{0,1,4,5,8}`).

Volumes are channels-last (B, X, Y, Z, 1); the whole forward computes in
the volumes' dtype with float32 parameters. `train=True` takes BatchNorm
batch statistics (weighted by `bn_mask` when given), moves the running
statistics, and applies dropout drawn from `generator`.
"""

from __future__ import annotations

from torch import nn

from ..nn.attention import CrossTransformerModAvg, Linear
from ..nn.batchnorm import BatchNormMasked
from ..nn.blocks import SNet, global_avg_pool, tokens_from_volume
from ..nn.dropout import Dropout
from ..nn.grl import revgrad


class _FusionHead(nn.Sequential):
    """Linear -> BN -> ReLU -> Dropout, twice (512, 64), -> Linear(64, 2)."""

    def __init__(self, in_features: int, drop_rate: float = 0.5):
        super().__init__(
            Linear(in_features, 512), BatchNormMasked(512), nn.ReLU(),
            Dropout(drop_rate),
            Linear(512, 64), BatchNormMasked(64), nn.ReLU(),
            Dropout(drop_rate),
            Linear(64, 2))

    def forward(self, x, train: bool = False, bn_mask=None, generator=None):
        layers = list(self)
        for i in (0, 4):
            lin, bn, relu, drop = layers[i:i + 4]
            x = drop(relu(bn(lin(x), train, bn_mask)), train, generator)
        return layers[8](x)


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
                 grl_alpha: float = 2.0, head_dropout: float = 0.5):
        super().__init__()
        self.grl_alpha = grl_alpha
        self.mri_cnn = SNet(dim)
        self.pet_cnn = SNet(dim)
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
        d_mri = self.D(revgrad(global_avg_pool(mri_feat), self.grl_alpha),
                       train, bn_mask)
        d_pet = self.D(revgrad(global_avg_pool(pet_feat), self.grl_alpha),
                       train, bn_mask)
        fused = self.fuse_transformer(tokens_from_volume(mri_feat),
                                      tokens_from_volume(pet_feat), train,
                                      generator)
        return self.fc_cls(fused, train, bn_mask, generator), d_mri, d_pet
