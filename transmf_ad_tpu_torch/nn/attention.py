"""Transformer blocks and the cross-modal fusion module, eval mode.

Port of transmf_ad_tpu/nn/attention.py (`FeedForward`, `Attention`,
`Transformer`, `CrossTransformerModAvg`). Module names follow the reference
torch code (`layers.{i}.{0,1}.norm`, `.fn.to_q`, `.fn.to_kv`, `.fn.to_out.0`,
`.fn.net.{0,3}`), which `transmf_ad_tpu.utils.torch_import` maps.

Parameters stay float32; each layer computes in the dtype of its input, as
the JAX modules do with `dtype` set: Linear casts its weights to it,
LayerNorm normalises in float32 and casts back.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from ..ops import attention_core
from ..ops.pooling import fused_token_pool


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
            Linear(dim, hidden_dim), nn.GELU(), nn.Dropout(dropout),
            Linear(hidden_dim, dim), nn.Dropout(dropout))

    def forward(self, x):
        return self.net(x)


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
        self.to_out = nn.Sequential(Linear(inner, dim), nn.Dropout(dropout))

    def forward(self, x, context=None):
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
        return self.to_out(out.transpose(1, 2).reshape(b, n, h * dh))


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

    def forward(self, x, context=None):
        for attn, ff in self.layers:
            x = attn(x, context=context) + x
            x = ff(x) + x
        return self.norm(x)


class CrossTransformerModAvg(nn.Module):
    """The paper's fusion module: per depth, a 1-layer Transformer with MRI
    queries over PET context, then one with PET queries over the updated
    MRI, each with an outer residual; then the fused GAP/GMP token pool ->
    (B, 4*dim) in the order [mri mean, pet mean, mri max, pet max]."""

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int,
                 mlp_dim: int, dropout: float = 0.0):
        super().__init__()
        self.layers = nn.ModuleList(
            nn.ModuleList([
                Transformer(dim, 1, heads, dim_head, mlp_dim, dropout),
                Transformer(dim, 1, heads, dim_head, mlp_dim, dropout),
            ]) for _ in range(depth))

    def forward(self, mri, pet):
        for mri_enc, pet_enc in self.layers:
            mri = mri_enc(mri, context=pet) + mri
            pet = pet_enc(pet, context=mri) + pet
        return fused_token_pool(mri, pet)
