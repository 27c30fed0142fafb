"""Swin UNETR's 3D Swin encoder (`swinViT`) as an MRI + PET classifier: the
plain float32 reference of the `swin_unetr` configuration.

Written from MONAI's `monai/networks/nets/swin_unetr.py` (`SwinUNETR`,
`SwinTransformer`, `BasicLayer`, `SwinTransformerBlock`, `WindowAttention`,
`PatchMergingV2`, `PatchEmbed`, `window_partition`, `window_reverse`,
`compute_mask`, `get_window_size`) as the code is written: `F.pad` of the
normalised tokens, `torch.roll`, `window_partition`, the relative position
table gathered through `relative_position_index[:n, :n]`, the -100 mask,
`softmax`, `window_reverse`, the roll back and the crop. Parameter names are
MONAI's (`swinViT.layers{i}.0.blocks.{j}.attn.qkv`, ...), which the program
shares, so one seeded state_dict loads into both. Every product's operands
go through `prec.q` (`layers.Precision`).

Where it departs from MONAI, and why:
- the MRI and the PET volume are the two input channels (MONAI's four
  BraTS sequences);
- the head is this configuration's own (Swin UNETR segments): stage 4's
  merged output layer-normed without affine, as `proj_out(normalize=True)`
  does, averaged over the grid, then `head`, Linear(16 * feature_size, 2);
  the other stages' `proj_out` outputs, which the decoder would read, are
  not computed;
- no `drop_path`, `pos_drop`, `attn_drop` or `proj_drop`: all are 0 in
  the configuration, and the modules with rate 0 are the identity;
- no `use_checkpoint` flag: each (sample, block) segment is always
  checkpointed (`torch.utils.checkpoint`, non-reentrant) and a stage's
  blocks run sample by sample, so that the full-resolution batch fits one
  card. That is exact: the model has no batch statistics and no dropout,
  so a sample's forward depends on that sample alone, and the backward
  recomputes the same values.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .layers import Precision

ADVERSARIAL = False


def window_partition(x, window_size):
    b, d, h, w, c = x.size()
    x = x.view(b, d // window_size[0], window_size[0], h // window_size[1],
               window_size[1], w // window_size[2], window_size[2], c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).contiguous().view(
        -1, window_size[0] * window_size[1] * window_size[2], c)


def window_reverse(windows, window_size, dims):
    b, d, h, w = dims
    x = windows.view(b, d // window_size[0], h // window_size[1],
                     w // window_size[2], window_size[0], window_size[1],
                     window_size[2], -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).contiguous().view(b, d, h, w,
                                                               -1)


def get_window_size(x_size, window_size, shift_size=None):
    use_window_size = list(window_size)
    if shift_size is not None:
        use_shift_size = list(shift_size)
    for i in range(len(x_size)):
        if x_size[i] <= window_size[i]:
            use_window_size[i] = x_size[i]
            if shift_size is not None:
                use_shift_size[i] = 0
    if shift_size is None:
        return tuple(use_window_size)
    return tuple(use_window_size), tuple(use_shift_size)


def compute_mask(dims, window_size, shift_size, device):
    cnt = 0
    d, h, w = dims
    img_mask = torch.zeros((1, d, h, w, 1), device=device)
    for d in (slice(-window_size[0]), slice(-window_size[0], -shift_size[0]),
              slice(-shift_size[0], None)):
        for h in (slice(-window_size[1]),
                  slice(-window_size[1], -shift_size[1]),
                  slice(-shift_size[1], None)):
            for w in (slice(-window_size[2]),
                      slice(-window_size[2], -shift_size[2]),
                      slice(-shift_size[2], None)):
                img_mask[:, d, h, w, :] = cnt
                cnt += 1
    mask_windows = window_partition(img_mask, window_size).squeeze(-1)
    attn_mask = mask_windows.unsqueeze(1) - mask_windows.unsqueeze(2)
    return attn_mask.masked_fill(attn_mask != 0, float(-100.0)).masked_fill(
        attn_mask == 0, float(0.0))


def linear(layer: nn.Linear, x, prec: Precision):
    return F.linear(prec.q(x), prec.q(layer.weight), layer.bias)


class WindowAttention(nn.Module):
    def __init__(self, dim, num_heads, window_size, qkv_bias):
        super().__init__()
        self.dim = dim
        self.window_size = window_size
        self.num_heads = num_heads
        head_dim = dim // num_heads
        self.scale = head_dim ** -0.5
        self.relative_position_bias_table = nn.Parameter(torch.zeros(
            (2 * window_size[0] - 1) * (2 * window_size[1] - 1)
            * (2 * window_size[2] - 1), num_heads))
        coords_d = torch.arange(self.window_size[0])
        coords_h = torch.arange(self.window_size[1])
        coords_w = torch.arange(self.window_size[2])
        coords = torch.stack(torch.meshgrid(coords_d, coords_h, coords_w,
                                            indexing="ij"))
        coords_flatten = torch.flatten(coords, 1)
        relative_coords = (coords_flatten[:, :, None]
                           - coords_flatten[:, None, :])
        relative_coords = relative_coords.permute(1, 2, 0).contiguous()
        relative_coords[:, :, 0] += self.window_size[0] - 1
        relative_coords[:, :, 1] += self.window_size[1] - 1
        relative_coords[:, :, 2] += self.window_size[2] - 1
        relative_coords[:, :, 0] *= ((2 * self.window_size[1] - 1)
                                     * (2 * self.window_size[2] - 1))
        relative_coords[:, :, 1] *= 2 * self.window_size[2] - 1
        relative_position_index = relative_coords.sum(-1)
        self.register_buffer("relative_position_index",
                             relative_position_index)
        self.qkv = nn.Linear(dim, dim * 3, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, mask, prec: Precision):
        b, n, c = x.shape
        qkv = linear(self.qkv, x, prec).reshape(
            b, n, 3, self.num_heads, c // self.num_heads).permute(
            2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        q = q * self.scale
        attn = prec.q(q) @ prec.q(k).transpose(-2, -1)
        relative_position_bias = self.relative_position_bias_table[
            self.relative_position_index.clone()[:n, :n].reshape(-1)
        ].reshape(n, n, -1)
        relative_position_bias = relative_position_bias.permute(
            2, 0, 1).contiguous()
        attn = attn + relative_position_bias.unsqueeze(0)
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.view(b // nw, nw, self.num_heads, n, n) + \
                mask.unsqueeze(1).unsqueeze(0)
            attn = attn.view(-1, self.num_heads, n, n)
        attn = torch.softmax(attn, dim=-1)
        x = (prec.q(attn) @ prec.q(v)).transpose(1, 2).reshape(b, n, c)
        return linear(self.proj, x, prec)


class MLPBlock(nn.Module):
    def __init__(self, hidden_size, mlp_dim):
        super().__init__()
        self.linear1 = nn.Linear(hidden_size, mlp_dim)
        self.linear2 = nn.Linear(mlp_dim, hidden_size)

    def forward(self, x, prec: Precision):
        return linear(self.linear2, F.gelu(linear(self.linear1, x, prec)),
                      prec)


class SwinTransformerBlock(nn.Module):
    def __init__(self, dim, num_heads, window_size, shift_size, mlp_ratio,
                 qkv_bias):
        super().__init__()
        self.window_size = window_size
        self.shift_size = shift_size
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, num_heads, self.window_size,
                                    qkv_bias)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = MLPBlock(dim, int(dim * mlp_ratio))

    def forward_part1(self, x, mask_matrix, prec):
        x = self.norm1(x)
        b, d, h, w, c = x.shape
        window_size, shift_size = get_window_size((d, h, w), self.window_size,
                                                  self.shift_size)
        pad_l = pad_t = pad_d0 = 0
        pad_d1 = (window_size[0] - d % window_size[0]) % window_size[0]
        pad_b = (window_size[1] - h % window_size[1]) % window_size[1]
        pad_r = (window_size[2] - w % window_size[2]) % window_size[2]
        x = F.pad(x, (0, 0, pad_l, pad_r, pad_t, pad_b, pad_d0, pad_d1))
        _, dp, hp, wp, _ = x.shape
        dims = [b, dp, hp, wp]
        if any(i > 0 for i in shift_size):
            shifted_x = torch.roll(x, shifts=(-shift_size[0], -shift_size[1],
                                              -shift_size[2]),
                                   dims=(1, 2, 3))
            attn_mask = mask_matrix
        else:
            shifted_x = x
            attn_mask = None
        x_windows = window_partition(shifted_x, window_size)
        attn_windows = self.attn(x_windows, attn_mask, prec)
        attn_windows = attn_windows.view(-1, *(window_size + (c,)))
        shifted_x = window_reverse(attn_windows, window_size, dims)
        if any(i > 0 for i in shift_size):
            x = torch.roll(shifted_x, shifts=(shift_size[0], shift_size[1],
                                              shift_size[2]), dims=(1, 2, 3))
        else:
            x = shifted_x
        if pad_d1 > 0 or pad_r > 0 or pad_b > 0:
            x = x[:, :d, :h, :w, :].contiguous()
        return x

    def forward(self, x, mask_matrix, prec):
        shortcut = x
        x = self.forward_part1(x, mask_matrix, prec)
        x = shortcut + x
        return x + self.mlp(self.norm2(x), prec)


class PatchMergingV2(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.reduction = nn.Linear(8 * dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(8 * dim)

    def forward(self, x, prec):
        b, d, h, w, c = x.size()
        pad_input = (h % 2 == 1) or (w % 2 == 1) or (d % 2 == 1)
        if pad_input:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2, 0, d % 2))
        x = torch.cat([x[:, i::2, j::2, k::2, :] for i, j, k in
                       itertools.product(range(2), range(2), range(2))], -1)
        x = self.norm(x)
        return linear(self.reduction, x, prec)


class BasicLayer(nn.Module):
    def __init__(self, dim, depth, num_heads, window_size, mlp_ratio,
                 qkv_bias):
        super().__init__()
        self.window_size = window_size
        self.shift_size = tuple(i // 2 for i in window_size)
        self.no_shift = tuple(0 for i in window_size)
        self.blocks = nn.ModuleList([
            SwinTransformerBlock(dim, num_heads, self.window_size,
                                 self.no_shift if (i % 2 == 0)
                                 else self.shift_size, mlp_ratio, qkv_bias)
            for i in range(depth)])
        self.downsample = PatchMergingV2(dim)

    def forward(self, x, prec):
        b, c, d, h, w = x.size()
        window_size, shift_size = get_window_size((d, h, w), self.window_size,
                                                  self.shift_size)
        x = x.permute(0, 2, 3, 4, 1)  # b c d h w -> b d h w c
        dp = int(np.ceil(d / window_size[0])) * window_size[0]
        hp = int(np.ceil(h / window_size[1])) * window_size[1]
        wp = int(np.ceil(w / window_size[2])) * window_size[2]
        attn_mask = compute_mask([dp, hp, wp], window_size, shift_size,
                                 x.device)
        for blk in self.blocks:
            # one checkpointed segment a (sample, block)
            x = torch.cat([checkpoint(blk, x[i:i + 1], attn_mask, prec,
                                      use_reentrant=False)
                           for i in range(b)])
        x = x.view(b, d, h, w, -1)
        x = self.downsample(x, prec)
        return x.permute(0, 4, 1, 2, 3)  # b d h w c -> b c d h w


class PatchEmbed(nn.Module):
    def __init__(self, patch_size, in_chans, embed_dim):
        super().__init__()
        self.patch_size = (patch_size,) * 3
        self.proj = nn.Conv3d(in_chans, embed_dim, kernel_size=patch_size,
                              stride=patch_size)

    def forward(self, x, prec):
        _, _, d, h, w = x.size()
        if w % self.patch_size[2] != 0:
            x = F.pad(x, (0, self.patch_size[2] - w % self.patch_size[2]))
        if h % self.patch_size[1] != 0:
            x = F.pad(x, (0, 0, 0, self.patch_size[1]
                          - h % self.patch_size[1]))
        if d % self.patch_size[0] != 0:
            x = F.pad(x, (0, 0, 0, 0, 0, self.patch_size[0]
                          - d % self.patch_size[0]))
        return F.conv3d(prec.q(x), prec.q(self.proj.weight), self.proj.bias,
                        stride=self.patch_size)


class SwinTransformer(nn.Module):
    def __init__(self, in_chans, embed_dim, window_size, patch_size, depths,
                 num_heads, mlp_ratio, qkv_bias):
        super().__init__()
        self.num_layers = len(depths)
        self.window_size = window_size
        self.patch_embed = PatchEmbed(patch_size, in_chans, embed_dim)
        for i_layer in range(self.num_layers):
            layer = BasicLayer(int(embed_dim * 2 ** i_layer), depths[i_layer],
                               num_heads[i_layer], self.window_size,
                               mlp_ratio, qkv_bias)
            setattr(self, f"layers{i_layer + 1}", nn.ModuleList([layer]))

    @staticmethod
    def proj_out(x):
        """`proj_out(x, normalize=True)`."""
        ch = int(x.shape[1])
        x = x.permute(0, 2, 3, 4, 1)
        x = F.layer_norm(x, [ch])
        return x.permute(0, 4, 1, 2, 3)

    def forward(self, x, prec):
        x = self.patch_embed(x, prec)
        for i in range(1, self.num_layers + 1):
            x = getattr(self, f"layers{i}")[0](x.contiguous(), prec)
        return self.proj_out(x)


class Model(nn.Module):
    def __init__(self, in_channels, feature_size, depths, num_heads,
                 window_size, patch_size, mlp_ratio, qkv_bias,
                 num_classes=2, **_):
        super().__init__()
        self.swinViT = SwinTransformer(in_channels, feature_size,
                                       (window_size,) * 3, patch_size,
                                       depths, num_heads, mlp_ratio, qkv_bias)
        self.head = nn.Linear(feature_size * 2 ** len(depths), num_classes)

    def forward(self, mri, pet, train, generator, prec: Precision):
        """mri, pet: (B, 1, X, Y, Z) -> logits (B, classes)."""
        x = self.swinViT(torch.cat([mri, pet], dim=1), prec)
        return linear(self.head, x.mean(dim=(2, 3, 4)), prec)
