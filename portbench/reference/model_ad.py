"""ModelAd, the paper's model (reference `models/mymodel.py` `model_ad`):
two sNet encoders, a gradient-reversal discriminator on each encoder's
spatial mean, cross-modal fusion (per depth, MRI queries over PET keys,
then PET queries over the updated MRI, each with an outer residual), the
[mean MRI, mean PET, max MRI, max PET] token pool and a BatchNorm MLP head
-> (logits, d_mri, d_pet)."""

from __future__ import annotations

import torch
from torch import nn

from .layers import (BN, FusionHead, Linear, Precision, SNet, encoder_pairs,
                     revgrad, tokens)

ADVERSARIAL = True


class Discriminator(nn.Module):
    """dim -> 128 -> BN -> ReLU -> 2 (slots 0, 1, 3)."""

    def __init__(self, dim):
        super().__init__()
        self.add_module("0", Linear(dim, 128))
        self.add_module("1", BN(128))
        self.add_module("3", Linear(128, 2))

    def forward(self, x, train, prec: Precision):
        m = self._modules
        h = m["1"](m["0"].run(x, prec, prec.bias(train)), train)
        return m["3"].run(torch.relu(h), prec)


class Model(nn.Module):
    def __init__(self, dim, depth, heads, dim_head, mlp_dim, head_dropout,
                 grl_alpha, **_):
        super().__init__()
        self.grl_alpha = grl_alpha
        self.mri_cnn, self.pet_cnn = SNet(dim), SNet(dim)
        self.D = Discriminator(dim)
        self.fuse_transformer = nn.Module()
        self.fuse_transformer.layers = encoder_pairs(depth, dim, heads,
                                                     dim_head, mlp_dim)
        self.fc_cls = FusionHead(4 * dim, head_dropout, batchnorm=True)

    def forward(self, mri, pet, train, generator, prec: Precision):
        """mri, pet: (B, 1, X, Y, Z) float32."""
        fm = self.mri_cnn(mri, train, prec)
        fp = self.pet_cnn(pet, train, prec)
        d_mri = self.D(revgrad(fm.mean(dim=(2, 3, 4)), self.grl_alpha),
                       train, prec)
        d_pet = self.D(revgrad(fp.mean(dim=(2, 3, 4)), self.grl_alpha),
                       train, prec)
        m, p = tokens(fm), tokens(fp)
        for mri_enc, pet_enc in self.fuse_transformer.layers:
            m = mri_enc(m, p, prec) + m
            p = pet_enc(p, m, prec) + p
        pooled = torch.cat([m.mean(1), p.mean(1), m.amax(1), p.amax(1)],
                           dim=-1)
        return self.fc_cls(pooled, train, generator, prec), d_mri, d_pet
