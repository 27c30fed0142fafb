"""The blocks of MONAI's 3D Swin transformer (`monai.networks.nets.swin_unetr`:
`WindowAttention`, `SwinTransformerBlock`, `PatchMergingV2`, `BasicLayer`,
`PatchEmbed`), channels-last throughout: MONAI's `BasicLayer` runs
channels-last inside and channels-first between stages, which changes no
value. Module and parameter names are MONAI's, so its state_dict loads as
it is.

The window attention between `qkv` and `proj` is the op
`ops/window_attention.py` (K14 on the card), which does the pad, roll,
partition, reverse and crop in its addressing; the norms, the MLP and the
merging are plain PyTorch. Parameters stay float32 and each layer computes
in its input's dtype, as `nn/attention.py`'s layers do. The stages'
spans (`utils/tracing.py`): `swin stage k` > `window attention` (norm1
through proj), `mlp` (norm2 through linear2) and `patch merging`.
"""

from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.window_attention import (relative_position_index, table_size,
                                    window_attention, window_size)
from ..utils import tracing
from .attention import LayerNorm, Linear


class WindowAttention(nn.Module):
    """MONAI's WindowAttention: qkv (bias on), the windows' attention with
    the relative position bias table and the shift mask, proj. `window` is
    the full window; the forward takes the window and shift the grid
    allows."""

    def __init__(self, dim: int, num_heads: int, window_size):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = tuple(window_size)
        self.scale = (dim // num_heads) ** -0.5
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros(table_size(self.window_size), num_heads))
        self.register_buffer("relative_position_index",
                             relative_position_index(self.window_size))
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)

    def forward(self, x, window, shift):
        """x: (B, X, Y, Z, C), already normalised -> (B, X, Y, Z, C)."""
        out = window_attention(self.qkv(x), self.qkv.bias.to(x.dtype),
                               self.relative_position_bias_table, window,
                               shift, self.window_size, self.scale)
        return self.proj(out)


class MLPBlock(nn.Module):
    """MONAI's MLPBlock: linear1, exact GELU, linear2 (no dropout)."""

    def __init__(self, hidden_size: int, mlp_dim: int):
        super().__init__()
        self.linear1 = Linear(hidden_size, mlp_dim)
        self.linear2 = Linear(mlp_dim, hidden_size)

    def forward(self, x):
        return self.linear2(F.gelu(self.linear1(x)))


class SwinTransformerBlock(nn.Module):
    """x + attn(norm1(x)), then x + mlp(norm2(x)); the window and shift
    clamped to the grid as MONAI's `get_window_size` clamps them."""

    def __init__(self, dim: int, num_heads: int, window, shift,
                 mlp_ratio: float = 4.0):
        super().__init__()
        self.window_size, self.shift_size = tuple(window), tuple(shift)
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, num_heads, window)
        self.norm2 = LayerNorm(dim)
        self.mlp = MLPBlock(dim, int(dim * mlp_ratio))

    def forward(self, x):
        window, shift = window_size(x.shape[1:4], self.window_size,
                                    self.shift_size)
        with tracing.span("window attention"):
            x = x + self.attn(self.norm1(x), window, shift)
        with tracing.span("mlp"):
            return x + self.mlp(self.norm2(x))


class PatchMergingV2(nn.Module):
    """Odd axes zero-padded by one, the eight (i, j, k) sub-grids
    concatenated in `itertools.product` order, LayerNorm(8C),
    Linear(8C, 2C) without bias."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(8 * dim)
        self.reduction = Linear(8 * dim, 2 * dim, bias=False)

    def forward(self, x):
        _, d, h, w, _ = x.shape
        if d % 2 or h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2, 0, d % 2))
        x = torch.cat([x[:, i::2, j::2, k::2, :] for i, j, k in
                       itertools.product(range(2), repeat=3)], -1)
        return self.reduction(self.norm(x))


class BasicLayer(nn.Module):
    """One stage: `depth` blocks, the odd ones shifted by half the window,
    then the patch merging."""

    def __init__(self, dim: int, depth: int, num_heads: int, window,
                 mlp_ratio: float = 4.0):
        super().__init__()
        window = tuple(window)
        shift = tuple(w // 2 for w in window)
        self.blocks = nn.ModuleList([
            SwinTransformerBlock(dim, num_heads, window,
                                 (0, 0, 0) if i % 2 == 0 else shift,
                                 mlp_ratio)
            for i in range(depth)])
        self.downsample = PatchMergingV2(dim)

    def forward(self, x):
        for blk in self.blocks:
            x = blk(x)
        with tracing.span("patch merging"):
            return self.downsample(x)


class PatchEmbed(nn.Module):
    """MONAI's PatchEmbed without a norm: the volume zero-padded at the
    high end to a multiple of the patch, then `proj`, a Conv3d with kernel
    and stride `patch_size`, computed as one linear map of each patch."""

    def __init__(self, patch_size: int, in_chans: int, embed_dim: int):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv3d(in_chans, embed_dim, kernel_size=patch_size,
                              stride=patch_size)

    def forward(self, x):
        """(B, X, Y, Z, Cin) -> (B, X / p, Y / p, Z / p, embed_dim)."""
        p = self.patch_size
        b, d, h, w, c = x.shape
        x = F.pad(x, (0, 0, 0, -w % p, 0, -h % p, 0, -d % p))
        d, h, w = (s // p for s in x.shape[1:4])
        x = x.view(b, d, p, h, p, w, p, c).permute(0, 1, 3, 5, 2, 4, 6, 7)
        x = x.reshape(b, d, h, w, p * p * p * c)
        weight = self.proj.weight.permute(0, 2, 3, 4, 1).reshape(
            self.proj.out_channels, -1)
        return F.linear(x, weight.to(x.dtype), self.proj.bias.to(x.dtype))


class SwinTransformer(nn.Module):
    """MONAI's SwinTransformer (`swinViT`), use_v2 False: the patch
    embedding and four stages; returns stage 4's merged output,
    channels-last."""

    def __init__(self, in_chans: int, embed_dim: int, window_size,
                 patch_size: int, depths, num_heads, mlp_ratio: float = 4.0):
        super().__init__()
        self.patch_embed = PatchEmbed(patch_size, in_chans, embed_dim)
        for i, (depth, heads) in enumerate(zip(depths, num_heads)):
            setattr(self, f"layers{i + 1}", nn.ModuleList([BasicLayer(
                embed_dim * 2 ** i, depth, heads, window_size, mlp_ratio)]))
        self.num_layers = len(depths)

    def forward(self, x):
        x = self.patch_embed(x)
        for i in range(1, self.num_layers + 1):
            with tracing.span(f"swin stage {i}"):
                x = getattr(self, f"layers{i}")[0](x)
        return x
