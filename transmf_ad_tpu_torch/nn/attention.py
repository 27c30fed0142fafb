"""Transformer blocks and the cross-modal fusion module.

Port of transmf_ad_tpu/nn/attention.py (`FeedForward`, `Attention`,
`Transformer`, `CrossTransformer`, `CrossTransformerModAvg`). Module names
follow the reference torch code (`layers.{i}.{0,1}.norm`, `.fn.to_q`,
`.fn.to_kv`, `.fn.to_out.0`, `.fn.net.{0,3}`), which
`transmf_ad_tpu.utils.torch_import` maps.

Parameters stay float32; each layer computes in the dtype of its input, as
the JAX modules do with `dtype` set: Linear casts its weights to it,
LayerNorm normalises in float32 and casts back. Dropout acts only with
`train=True` and draws from the `generator` passed down.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import attention_core
from ..ops.pooling import fused_token_pool
from .dropout import Dropout


class Linear(nn.Linear):
    """nn.Linear computing in the input's dtype (float32 master weights)."""

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


class LayerNorm(nn.LayerNorm):
    """LayerNorm (eps 1e-5) normalising in float32, cast back."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=1e-5)

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape,
                            self.weight.float(), self.bias.float(),
                            self.eps).to(x.dtype)


class PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = LayerNorm(dim)
        self.fn = fn

    def forward(self, x, **kw):
        return self.fn(self.norm(x), **kw)


class FeedForward(nn.Module):
    """Linear -> GELU (exact) -> Dropout -> Linear -> Dropout."""

    def __init__(self, dim: int, hidden_dim: int, dropout: float = 0.0):
        super().__init__()
        self.net = nn.Sequential(
            Linear(dim, hidden_dim), nn.GELU(), Dropout(dropout),
            Linear(hidden_dim, dim), Dropout(dropout))

    def forward(self, x, train: bool = False, generator=None):
        lin1, gelu, drop1, lin2, drop2 = self.net
        x = drop1(gelu(lin1(x)), train, generator)
        return drop2(lin2(x), train, generator)


class Attention(nn.Module):
    """Multi-head attention, queries from x, keys/values from `context`
    (x itself when None). No q/kv bias; k and v are the first and second
    halves of `to_kv`; scale dim_head ** -0.5."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 64,
                 dropout: float = 0.0):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.to_q = Linear(dim, inner, bias=False)
        self.to_kv = Linear(dim, 2 * inner, bias=False)
        self.to_out = nn.Sequential(Linear(inner, dim), Dropout(dropout))

    def forward(self, x, context=None, train: bool = False, generator=None):
        ctx = x if context is None else context
        b, n, _ = x.shape
        m = ctx.shape[1]
        h, dh = self.heads, self.dim_head

        def heads_first(t, length):  # (B, L, H*dh) -> (B, H, L, dh)
            return t.reshape(b, length, h, dh).transpose(1, 2).contiguous()

        k, v = self.to_kv(ctx).chunk(2, dim=-1)
        out = attention_core(heads_first(self.to_q(x), n),
                             heads_first(k, m), heads_first(v, m),
                             scale=dh ** -0.5)
        proj, drop = self.to_out
        return drop(proj(out.transpose(1, 2).reshape(b, n, h * dh)), train,
                    generator)


class Transformer(nn.Module):
    """depth x [PreNorm attention + residual, PreNorm feed-forward +
    residual], then a final LayerNorm. `context` feeds every layer's
    attention un-normalised (cross-attention when given)."""

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int,
                 mlp_dim: int, dropout: float = 0.0):
        super().__init__()
        self.layers = nn.ModuleList(
            nn.ModuleList([
                PreNorm(dim, Attention(dim, heads, dim_head, dropout)),
                PreNorm(dim, FeedForward(dim, mlp_dim, dropout)),
            ]) for _ in range(depth))
        self.norm = LayerNorm(dim)

    def forward(self, x, context=None, train: bool = False, generator=None):
        kw = dict(train=train, generator=generator)
        for attn, ff in self.layers:
            x = attn(x, context=context, **kw) + x
            x = ff(x, **kw) + x
        return self.norm(x)


def _encoder_pairs(depth: int, share: bool, *args) -> nn.ModuleList:
    """`depth` pairs (MRI, PET) of 1-layer Transformers, named
    layers.{i}.{0,1}; with `share` a pair holds one encoder twice."""
    pairs = []
    for _ in range(depth):
        mri_enc = Transformer(*args)
        pairs.append(nn.ModuleList(
            [mri_enc, mri_enc if share else Transformer(*args)]))
    return nn.ModuleList(pairs)


class CrossTransformer(nn.Module):
    """Joint-context fusion: per depth, each stream attends over
    concat(mri, pet) through its own 1-layer Transformer, with an outer
    residual; the PET stream's context holds the MRI tokens already
    updated. share=True applies one encoder to both streams (its weights
    appear under both names of the pair). Returns (mri, pet)."""

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int,
                 mlp_dim: int, dropout: float = 0.0, share: bool = False):
        super().__init__()
        self.layers = _encoder_pairs(depth, share, dim, 1, heads, dim_head,
                                     mlp_dim, dropout)

    def forward(self, mri, pet, train: bool = False, generator=None):
        kw = dict(train=train, generator=generator)
        for mri_enc, pet_enc in self.layers:
            mri = mri_enc(mri, context=torch.cat([mri, pet], dim=1),
                          **kw) + mri
            pet = pet_enc(pet, context=torch.cat([mri, pet], dim=1),
                          **kw) + pet
        return mri, pet


class CrossTransformerModAvg(nn.Module):
    """The paper's fusion module: per depth, a 1-layer Transformer with MRI
    queries over PET context, then one with PET queries over the updated
    MRI, each with an outer residual; then the fused GAP/GMP token pool ->
    (B, 4*dim) in the order [mri mean, pet mean, mri max, pet max]."""

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int,
                 mlp_dim: int, dropout: float = 0.0):
        super().__init__()
        self.layers = _encoder_pairs(depth, False, dim, 1, heads, dim_head,
                                     mlp_dim, dropout)

    def forward(self, mri, pet, train: bool = False, generator=None):
        kw = dict(train=train, generator=generator)
        for mri_enc, pet_enc in self.layers:
            mri = mri_enc(mri, context=pet, **kw) + mri
            pet = pet_enc(pet, context=mri, **kw) + pet
        return fused_token_pool(mri, pet)
