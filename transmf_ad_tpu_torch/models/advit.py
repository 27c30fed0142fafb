"""ADVIT baseline: depth-collapse convs and a 2D ViT a modality.

Port of transmf_ad_tpu/models/advit.py (reference: models/ADVIT.py). Per
modality a "to-2d" stack, two (1, 1, 25) VALID ConvBNAct blocks with ReLU,
each followed by a (1, 1, 2) max pool, collapses the 79-slice depth to 1;
the (128, 128) plane goes through a ViT encoder (patch 16, dim 192, depth
6, heads 3 x 64, mlp 768, dropout 0.1) whose CLS latent is the modality's
feature; the two latents are concatenated into Linear(384, 2) -> logits.

The ViT follows vit_pytorch 1.7.4, the version the reference pins, down to
its names, which transmf_ad_tpu/utils/torch_import.py reads:
`to_patch_embedding.{1,2,3}` (LayerNorm, Linear, LayerNorm after the
patch rearrange in slot 0), `cls_token`, `pos_embedding`,
`transformer.layers.{i}.0.{norm,to_qkv,to_out.0}` with ONE fused
(3 * inner, dim) `to_qkv` weight whose rows are q, then k, then v,
`transformer.layers.{i}.1.net.{0,1,4}` (LayerNorm, Linear, Linear) and
`transformer.norm`. Attention runs through `attention_core`: kernel K2 on
the card, 65 tokens of head dim 64 at 128 x 128.

The JAX modules infer the patch grid and the collapsed depth from their
first input; a torch module needs them when it is built, so `ADVIT` takes
the padded volume's `input_shape`.
"""

from __future__ import annotations

import torch
from torch import nn

from ..nn.attention import LayerNorm, Linear
from ..nn.batchnorm import ManualBN
from ..nn.blocks import BAND_MIN_VOXELS, conv_bn_act, max_pool_window
from ..nn.dropout import Dropout, dropout
from ..ops import attention_core
from ..parallel.tensor import full

DEPTH_KERNEL = 25  # the to-2d convs' (1, 1, 25) window


def collapsed_depth(z: int) -> int:
    """The depth left after the to-2d stack: 79 -> 55 -> 27 -> 3 -> 1."""
    for _ in range(2):
        z = (z - DEPTH_KERNEL + 1) // 2
    return z


class DepthCollapse(nn.ModuleDict):
    """The to-2d stack (reference slots 0 / 1 and 4 / 5: conv and BN;
    ReLU and the pools hold no weights): (B, X, Y, Z, 1) ->
    (B, X, Y, collapsed_depth(Z))."""

    def __init__(self):
        super().__init__({"0": nn.Conv3d(1, 32, (1, 1, DEPTH_KERNEL)),
                          "1": ManualBN(32),
                          "4": nn.Conv3d(32, 1, (1, 1, DEPTH_KERNEL)),
                          "5": ManualBN(1)})

    def forward(self, x, train: bool = False, bn_mask=None):
        for cs, bs in (("0", "1"), ("4", "5")):
            x = conv_bn_act(x, self[cs], self[bs], act="relu", train=train,
                            bn_mask=bn_mask, band_min_voxels=BAND_MIN_VOXELS)
            x = max_pool_window(x, (1, 1, 2))
        b, h, w, d, c = x.shape
        return x.reshape(b, h, w, d * c)


class _Patchify(nn.Module):
    """(B, H, W, C) -> (B, gh * gw, p * p * C): rearrange 'b (h p1) (w p2)
    c -> b (h w) (p1 p2 c)', the slot 0 of vit_pytorch's embedding."""

    def __init__(self, patch: int):
        super().__init__()
        self.patch = patch

    def forward(self, img):
        b, h, w, c = img.shape
        p = self.patch
        x = img.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(b, (h // p) * (w // p), p * p * c)


class _ViTAttention(nn.Module):
    """Pre-LN self-attention with a fused q / k / v projection, no bias."""

    def __init__(self, dim: int, heads: int, dim_head: int, drop: float):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.norm = LayerNorm(dim)
        self.to_qkv = Linear(dim, 3 * inner, bias=False)
        self.to_out = nn.Sequential(Linear(inner, dim), Dropout(drop))

    def forward(self, x, train: bool = False, generator=None):
        b, n, _ = x.shape
        h, dh = self.heads, self.dim_head
        q, k, v = (t.reshape(b, n, h, dh).transpose(1, 2).contiguous()
                   for t in self.to_qkv(self.norm(x)).chunk(3, dim=-1))
        out = attention_core(q, k, v, scale=dh ** -0.5)
        proj, drop = self.to_out
        return drop(proj(out.transpose(1, 2).reshape(b, n, h * dh)), train,
                    generator)


class _ViTFeedForward(nn.Module):
    """LayerNorm -> Linear -> GELU (exact) -> Dropout -> Linear -> Dropout."""

    def __init__(self, dim: int, hidden: int, drop: float):
        super().__init__()
        self.net = nn.Sequential(LayerNorm(dim), Linear(dim, hidden),
                                 nn.GELU(), Dropout(drop),
                                 Linear(hidden, dim), Dropout(drop))

    def forward(self, x, train: bool = False, generator=None):
        norm, lin1, gelu, drop1, lin2, drop2 = self.net
        x = drop1(gelu(lin1(norm(x))), train, generator)
        return drop2(lin2(x), train, generator)


class _ViTTransformer(nn.Module):
    """depth x [attention + residual, feed-forward + residual], then a
    final LayerNorm: the JAX package's pre-LN `Transformer` under
    vit_pytorch's names."""

    def __init__(self, dim, depth, heads, dim_head, mlp_dim, drop):
        super().__init__()
        self.layers = nn.ModuleList(
            nn.ModuleList([_ViTAttention(dim, heads, dim_head, drop),
                           _ViTFeedForward(dim, mlp_dim, drop)])
            for _ in range(depth))
        self.norm = LayerNorm(dim)

    def forward(self, x, train: bool = False, generator=None):
        for attn, ff in self.layers:
            x = attn(x, train, generator) + x
            x = ff(x, train, generator) + x
        return self.norm(x)


class ViTEncoder(nn.Module):
    """2D ViT encoder returning the CLS latent: (B, H, W, C) -> (B, dim).
    `image_size` (H, W) fixes the patch grid, so the length of
    `pos_embedding` (gh * gw + 1)."""

    def __init__(self, image_size=(128, 128), patch_size: int = 16,
                 dim: int = 192, depth: int = 6, heads: int = 3,
                 mlp_dim: int = 768, dropout: float = 0.1,
                 emb_dropout: float = 0.1, channels: int = 1):
        super().__init__()
        self.image_size, self.channels = tuple(image_size), channels
        self.emb_dropout = emb_dropout
        gh, gw = (s // patch_size for s in image_size)
        patch_dim = patch_size * patch_size * channels
        self.to_patch_embedding = nn.Sequential(
            _Patchify(patch_size), LayerNorm(patch_dim),
            Linear(patch_dim, dim), LayerNorm(dim))
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embedding = nn.Parameter(torch.zeros(1, gh * gw + 1, dim))
        self.transformer = _ViTTransformer(dim, depth, heads, dim // heads,
                                           mlp_dim, dropout)

    def forward(self, img, train: bool = False, generator=None):
        if tuple(img.shape[1:]) != (*self.image_size, self.channels):
            raise ValueError(f"ViTEncoder built for (B, {self.image_size}, "
                             f"{self.channels}) planes, got "
                             f"{tuple(img.shape)}")
        x = self.to_patch_embedding(img)
        # whole, where the model axis shards them (their last dimension)
        cls = full(self.cls_token).to(x.dtype).expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1) + full(self.pos_embedding).to(x.dtype)
        x = dropout(x, self.emb_dropout, train, generator)
        return self.transformer(x, train, generator)[:, 0]


class ADVIT(nn.Module):
    """Dual-modality depth-collapse + ViT classifier. input_shape: the
    padded (X, Y, Z) volume, (128, 128, 79) in the reference driver;
    vit_dropout / emb_dropout: the ViTs' (the reference's 0.1; not named
    `dropout`, which `build_model` passes to the fusion models alone)."""

    def __init__(self, input_shape=(128, 128, 79), vit_dropout: float = 0.1,
                 emb_dropout: float = 0.1):
        super().__init__()
        x, y, z = input_shape
        kw = dict(image_size=(x, y), channels=collapsed_depth(z),
                  dropout=vit_dropout, emb_dropout=emb_dropout)
        self.to_2d_mri = DepthCollapse()
        self.to_2d_pet = DepthCollapse()
        self.vit_mri = ViTEncoder(**kw)
        self.vit_pet = ViTEncoder(**kw)
        self.fc = Linear(2 * 192, 2)

    def forward(self, mri, pet, train: bool = False, bn_mask=None,
                generator=None):
        """mri, pet: (B, X, Y, Z, 1) -> logits (B, 2)."""
        mri_lat = self.vit_mri(self.to_2d_mri(mri, train, bn_mask), train,
                               generator)
        pet_lat = self.vit_pet(self.to_2d_pet(pet, train, bn_mask), train,
                               generator)
        return self.fc(torch.cat([mri_lat, pet_lat], dim=-1))
