"""Transformer blocks and the cross-modal fusion module.

Port of transmf_ad_tpu/nn/attention.py (`FeedForward`, `Attention`,
`Transformer`, `CrossTransformer`, `CrossTransformerModAvg`, and the
library extra `PositionalEncoding1D`). Module names
follow the reference torch code (`layers.{i}.{0,1}.norm`, `.fn.to_q`,
`.fn.to_kv`, `.fn.to_out.0`, `.fn.net.{0,3}`), which
`transmf_ad_tpu.utils.torch_import` maps.

Over the tensor-parallel 'model' axis (`parallel/tensor.py`) a sharded
`Linear` computes its rank's output features and gathers them. Where the
heads divide over the axis and both projections are sharded, `Attention`
runs the rank's heads alone: `to_q`'s rows are its heads, `to_kv`'s rows
are cut as two blocks (k, then v), so its rows are those heads' keys and
values, and the kernel's output is gathered into `to_out`. Otherwise it
runs every head on the gathered projections.

Parameters stay float32; each layer computes in the dtype of its input, as
the JAX modules do with `dtype` set: Linear casts its weights to it,
LayerNorm normalises in float32 and casts back. Dropout acts only with
`train=True` and draws from the `generator` passed down.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import attention_core
from ..ops.pooling import fused_token_pool
from ..parallel.tensor import shard_of
from .dropout import Dropout


class Linear(nn.Linear):
    """nn.Linear computing in the input's dtype (float32 master weights);
    sharded over the model axis, it computes the rank's output features
    (`column`) and all-gathers them."""

    def forward(self, x):
        s = shard_of(self.weight)
        if s is not None:
            return s.gather(self.column(x), -1)
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)

    def column(self, x):
        """A sharded Linear's output features of this rank, from the
        replicated `x`."""
        s = shard_of(self.weight)
        x = s.axis.copy_in(x)
        b = None if self.bias is None else s.local(self.bias).to(x.dtype)
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
    (x itself when None; with `kv_include_self`, x followed by the
    context). No q/kv bias; k and v are the first and second halves of
    `to_kv`; scale dim_head ** -0.5."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 64,
                 dropout: float = 0.0):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.to_q = Linear(dim, inner, bias=False)
        self.to_kv = Linear(dim, 2 * inner, bias=False)
        self.to_kv.shard_blocks = 2  # k, then v: each cut over the ranks
        self.to_out = nn.Sequential(Linear(inner, dim), Dropout(dropout))

    def forward(self, x, context=None, train: bool = False, generator=None,
                kv_include_self: bool = False):
        ctx = x if context is None else context
        if kv_include_self:
            ctx = torch.cat([x, ctx], dim=1)
        b, n, _ = x.shape
        m = ctx.shape[1]
        h, dh = self.heads, self.dim_head
        sq, skv = shard_of(self.to_q.weight), shard_of(self.to_kv.weight)
        split = (sq is not None and skv is not None
                 and h % sq.axis.size == 0)
        if split:  # this rank's heads
            h //= sq.axis.size
            q, kv = self.to_q.column(x), self.to_kv.column(ctx)
        else:
            q, kv = self.to_q(x), self.to_kv(ctx)

        def heads_first(t, length):  # (B, L, H*dh) -> (B, H, L, dh)
            return t.reshape(b, length, h, dh).transpose(1, 2).contiguous()

        k, v = kv.chunk(2, dim=-1)
        out = attention_core(heads_first(q, n), heads_first(k, m),
                             heads_first(v, m), scale=dh ** -0.5)
        out = out.transpose(1, 2).reshape(b, n, h * dh)
        if split:
            out = sq.gather(out, -1)
        proj, drop = self.to_out
        return drop(proj(out), train, generator)


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


class PositionalEncoding1D(nn.Module):
    """1D sinusoidal positional encoding (reference: models/networks.py:
    178-211, a library extra no model uses): (B, N, *) tokens ->
    (B, N, channels), sin then cos of position * 10000^(-2i / ch), in the
    tokens' dtype."""

    def __init__(self, channels: int):
        super().__init__()
        self.channels = channels

    def forward(self, tokens):
        b, n = tokens.shape[:2]
        ch = int(math.ceil(self.channels / 2) * 2)
        dev = tokens.device
        inv_freq = 1.0 / (10000 ** (torch.arange(0, ch, 2, dtype=torch.float32,
                                                 device=dev) / ch))
        ang = torch.arange(n, dtype=torch.float32, device=dev)[:, None] \
            * inv_freq[None]
        emb = torch.cat([torch.sin(ang), torch.cos(ang)],
                        dim=-1)[:, :self.channels]
        return emb[None].expand(b, n, self.channels).to(tokens.dtype)
