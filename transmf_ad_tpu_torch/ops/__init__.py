"""Hand-written Hopper kernels and their dispatch points.

Each public function here takes the JAX package's layout. On a CUDA tensor
it launches its kernel (or raises); on a CPU tensor it runs the plain
PyTorch version that sits beside it. `attention_core` is the single entry the
nn layer calls for attention.
"""

from __future__ import annotations

from .band_conv import BAND_CONV, BAND_DW
from .flash_attention import ATTENTION, FLASH_MIN_KEYS, fused_attention
from .pool3d import AFFINE_ACT_POOL, AFFINE_ACT_POOL_BWD
from .pooling import TOKEN_POOL
from .stem import STEM_CONV, STEM_CONV_STATS, STEM_DW

# K1-K9, in that order
KERNELS = (TOKEN_POOL, ATTENTION, STEM_CONV, AFFINE_ACT_POOL, STEM_CONV_STATS,
           STEM_DW, AFFINE_ACT_POOL_BWD, BAND_CONV, BAND_DW)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def attention_core(q, k, v, scale: float):
    """softmax(q k^T * scale) v for (B, H, N, D) q and (B, H, M, D) k/v.

    Up to `FLASH_MIN_KEYS` keys this is the single-pass kernel K2, as in the
    JAX package. Above it the JAX package switches to its KV-blocked flash
    kernel, which is not ported yet (ROADMAP.md, Queue 2, item 8): a CUDA
    tensor then raises instead of falling back.
    """
    if q.device.type != "cpu" and k.shape[2] > FLASH_MIN_KEYS:
        raise NotImplementedError(
            f"attention over {k.shape[2]} > {FLASH_MIN_KEYS} keys needs the "
            "flash kernel, still to port (ROADMAP.md Queue 2 item 8)")
    return fused_attention(q, k, v, scale)
