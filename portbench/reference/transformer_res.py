"""ModelTransformerRes (reference `models/mymodel.py`
`model_transformer_res`): ModelAd's two sNet encoders; per depth each
stream attends over the concatenation of both streams' tokens (the PET
stream over the MRI tokens already updated), with an outer residual; the
encoder tokens added back, each stream's token mean, and a BatchNorm-free
MLP head -> logits."""

from __future__ import annotations

import torch
from torch import nn

from .layers import FusionHead, Precision, SNet, encoder_pairs, tokens

ADVERSARIAL = False


class Model(nn.Module):
    def __init__(self, dim, depth, heads, dim_head, mlp_dim, head_dropout,
                 **_):
        super().__init__()
        self.mri_cnn, self.pet_cnn = SNet(dim), SNet(dim)
        self.fuse_transformer = nn.Module()
        self.fuse_transformer.layers = encoder_pairs(depth, dim, heads,
                                                     dim_head, mlp_dim)
        self.fc_cls = FusionHead(2 * dim, head_dropout, batchnorm=False)

    def forward(self, mri, pet, train, generator, prec: Precision):
        m0 = tokens(self.mri_cnn(mri, train, prec))
        p0 = tokens(self.pet_cnn(pet, train, prec))
        m, p = m0, p0
        for mri_enc, pet_enc in self.fuse_transformer.layers:
            m = mri_enc(m, torch.cat([m, p], dim=1), prec) + m
            p = pet_enc(p, torch.cat([m, p], dim=1), prec) + p
        pooled = torch.cat([(m + m0).mean(1), (p + p0).mean(1)], dim=-1)
        return self.fc_cls(pooled, train, generator, prec)
