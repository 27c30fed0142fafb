"""Hand-written Hopper kernels, reached through registered ops.

Each public function here takes the JAX package's layout and calls one op
of the `transmf` namespace (`_build.define_op`; `_build.OPS` lists them). The
registration picks the implementation by the tensors' device: on CUDA
tensors the op launches its kernel (or raises), on CPU tensors it runs the
plain PyTorch version that sits beside it, and FakeTensors (`torch.export`,
`torch.library.opcheck`) see its fake implementation. Gradients are the
ops' registered autograd formulas. `attention_core` is the single entry the
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
from .window_attention import WINDOW_BWD, WINDOW_FWD

# K1-K12, in that order, then K14's forward and backward
KERNELS = (TOKEN_POOL, ATTENTION, STEM_CONV, AFFINE_ACT_POOL, STEM_CONV_STATS,
           STEM_DW, AFFINE_ACT_POOL_BWD, BAND_CONV, BAND_DW, FLASH_FWD,
           FLASH_DQ, FLASH_DKV, WINDOW_FWD, WINDOW_BWD)


def reset_launch_counts() -> None:
    """Set the launch counts of KERNELS and of K13, the train step's
    augmentation (`data/transforms.py`; no op, so not in KERNELS), to 0.
    K13 is imported here, not with the ops: serving loads no data
    module."""
    from ..data.transforms import AUGMENT

    for k in (*KERNELS, AUGMENT):
        k.reset()


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
