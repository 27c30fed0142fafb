"""`SwinUNETRClassifier`: Swin UNETR's 3D Swin encoder as an MRI + PET
classifier.

The encoder is MONAI's `SwinUNETR.swinViT` (Hatamizadeh et al., BrainLes
2021, arXiv:2201.01266) at the paper's BraTS 2021 setting: patch 2,
feature size 48 (the paper's; MONAI's class default is 24), depths (2, 2,
2, 2), heads (3, 6, 12, 24), window 7, mlp ratio 4, qkv bias, no dropout
or drop path, and `downsample="mergingv2"` (chosen here; MONAI's class
default is "merging"). The MRI and the PET volume
are its two input channels, as MONAI's multi-sequence form takes the BraTS
sequences. Swin UNETR segments; the head here is this model's own: stage
4's merged output layer-normed without affine (`proj_out(normalize=True)`),
averaged over the grid, and `head`, Linear(16 * feature_size, classes).
The model has no BatchNorm and no dropout: `bn_mask` and `generator` are
taken for the train step's sake. The arguments that have one legal value
here (`qkv_bias`, the dropouts, `normalize`, `downsample`) are taken so that
a MONAI-style configuration reads as it is, and raise on any other value.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.attention import Linear
from ..nn.swin import SwinTransformer


class SwinUNETRClassifier(nn.Module):
    def __init__(self, in_channels: int = 2, feature_size: int = 48,
                 depths=(2, 2, 2, 2), num_heads=(3, 6, 12, 24),
                 window_size: int = 7, patch_size: int = 2,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                 dropout_path_rate: float = 0.0, normalize: bool = True,
                 downsample: str = "mergingv2", num_classes: int = 2):
        super().__init__()
        if not qkv_bias or drop_rate or attn_drop_rate or dropout_path_rate \
                or not normalize or downsample != "mergingv2":
            raise ValueError(
                "SwinUNETRClassifier runs one setting alone: qkv_bias=True, "
                "no dropout or drop path, normalize=True and downsample="
                "'mergingv2' (MONAI's class default is 'merging')")
        self.swinViT = SwinTransformer(
            in_channels, feature_size, (window_size,) * 3, patch_size,
            tuple(depths), tuple(num_heads), mlp_ratio)
        self.head = Linear(feature_size * 2 ** len(depths), num_classes)

    def forward(self, mri, pet, train: bool = False, bn_mask=None,
                generator=None):
        """mri, pet: (B, X, Y, Z, 1) -> logits (B, classes)."""
        x = self.swinViT(torch.cat([mri, pet], dim=-1))
        x = F.layer_norm(x.float(), x.shape[-1:])
        return self.head(x.mean(dim=(1, 2, 3)).to(mri.dtype))
