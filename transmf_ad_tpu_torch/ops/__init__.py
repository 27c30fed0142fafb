"""Hand-written Hopper kernels and their dispatch points.

Each public function here takes the JAX package's layout. On a CUDA tensor
it launches its kernel (or raises); on a CPU tensor it runs the plain
PyTorch version that sits beside it. `attention_core` is the single entry the
nn layer calls for attention.
"""

from __future__ import annotations

from .band_conv import BAND_CONV, BAND_DW
from .flash_attention import (ATTENTION, FLASH_DKV, FLASH_DQ, FLASH_FWD,
                              FLASH_MIN_KEYS, fused_attention)
# under another name: `ops.flash_attention` stays the submodule
from .flash_attention import flash_attention as _flash_attention
from .pool3d import AFFINE_ACT_POOL, AFFINE_ACT_POOL_BWD
from .pooling import TOKEN_POOL
from .stem import STEM_CONV, STEM_CONV_STATS, STEM_DW

# K1-K12, in that order
KERNELS = (TOKEN_POOL, ATTENTION, STEM_CONV, AFFINE_ACT_POOL, STEM_CONV_STATS,
           STEM_DW, AFFINE_ACT_POOL_BWD, BAND_CONV, BAND_DW, FLASH_FWD,
           FLASH_DQ, FLASH_DKV)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def attention_core(q, k, v, scale: float):
    """softmax(q k^T * scale) v for (B, H, N, D) q and (B, H, M, D) k/v.

    Up to `FLASH_MIN_KEYS` keys this is the single-pass kernel K2 with a
    plain backward; above it the KV-blocked flash kernels K10-K12, as in the
    JAX package. On CPU tensors each runs its plain version. The gate is this
    module's `FLASH_MIN_KEYS`, read at every call, so a test can lower it.
    """
    if k.shape[2] > FLASH_MIN_KEYS:
        return _flash_attention(q, k, v, scale)
    return fused_attention(q, k, v, scale)
