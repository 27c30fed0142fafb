"""Single-pass attention forward.

Port of `fused_attention` from transmf_ad_tpu/ops/flash_attention.py
(kernel K2, csrc/attention.cu). The KV-blocked `flash_attention` used above
`FLASH_MIN_KEYS` keys, and both backward passes, are still to port.
"""

from __future__ import annotations

import torch

from .._build import FLOAT, INT, PTR, Kernel, check_cuda

FLASH_MIN_KEYS = 2048  # above this the JAX package uses its flash kernel

ATTENTION = Kernel(
    name="attention_fwd", entry="transmf_attention_fwd",
    argtypes=(PTR, PTR, PTR, PTR, INT, INT, INT, INT, FLOAT, INT),
    source="transmf_ad_tpu_torch/csrc/attention.cu",
    replaces="transmf_ad_tpu/ops/flash_attention.py:78")

MAX_HEAD_DIM = 128


def attention_reference(q, k, v, scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v in float32, rounded once to q's dtype.
    q: (..., N, D), k/v: (..., M, D)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype)


def fused_attention(q, k, v, scale: float) -> torch.Tensor:
    """q: (B, H, N, D), k/v: (B, H, M, D) -> (B, H, N, D). Kernel K2 on CUDA
    tensors (D <= 128, any M); the plain version on CPU tensors."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, scale)
    dtype = check_cuda("fused_attention", q, k, v)
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 \
            or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]:
        raise ValueError(f"fused_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    b, h, n, d = q.shape
    m = k.shape[2]
    if d > MAX_HEAD_DIM:
        raise ValueError(f"fused_attention: head dim {d} > {MAX_HEAD_DIM}")
    out = torch.empty_like(q)
    ATTENTION.launch(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), b * h, n, m, d, float(scale), dtype)
    return out
