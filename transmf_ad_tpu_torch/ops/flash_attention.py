"""Single-pass attention.

Port of `fused_attention` from transmf_ad_tpu/ops/flash_attention.py: the
forward is kernel K2 (csrc/attention.cu); the backward is a plain float32
recompute, as the JAX package's is XLA (`_bwd_reference`). The KV-blocked
`flash_attention` used above `FLASH_MIN_KEYS` keys, with its Pallas forward
and backward kernels, is still to port (ROADMAP.md Queue 2 item 8).
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


def attention_bwd_reference(q, k, v, g, scale: float):
    """(dq, dk, dv) of `attention_reference` for the output gradient g:
    softmax recomputed in float32, each gradient rounded once to its
    input's dtype."""
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    p = torch.softmax(torch.matmul(qf, kf.transpose(-1, -2)) * scale, dim=-1)
    dv = torch.matmul(p.transpose(-1, -2), gf)
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _attention(q, k, v, scale: float) -> torch.Tensor:
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


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return _attention(q, k, v, scale)

    @staticmethod
    def backward(ctx, g):
        return (*attention_bwd_reference(*ctx.saved_tensors, g.contiguous(),
                                         ctx.scale), None)


def fused_attention(q, k, v, scale: float) -> torch.Tensor:
    """q: (B, H, N, D), k/v: (B, H, M, D) -> (B, H, N, D). Kernel K2 on CUDA
    tensors (D <= 128, any M); the plain version on CPU tensors.
    Differentiable, with a plain backward."""
    return _Attention.apply(q, k, v, scale)
