"""Single-pass attention and KV-blocked flash attention.

Port of transmf_ad_tpu/ops/flash_attention.py. `fused_attention`: the forward
is kernel K2 (csrc/attention.cu); the backward is a plain float32 recompute,
as the JAX package's is XLA (`_bwd_reference`). `flash_attention`, which
`attention_core` takes above `FLASH_MIN_KEYS` keys: the forward is K10 and
saves the float32 logsumexp of every query row; the backward is K11 (dq) and
K12 (dk, dv), which recompute the probabilities from that logsumexp
(csrc/flash_attention.cu). The TPU kernels' `block_q`/`block_k` arguments
tile VMEM and have no counterpart here.
"""

from __future__ import annotations

import torch

from .._build import FLOAT, INT, PTR, Kernel, check_cuda

FLASH_MIN_KEYS = 2048  # above this `attention_core` takes flash_attention

ATTENTION = Kernel(
    name="attention_fwd", entry="transmf_attention_fwd",
    argtypes=(PTR, PTR, PTR, PTR, INT, INT, INT, INT, FLOAT, INT),
    source="transmf_ad_tpu_torch/csrc/attention.cu",
    replaces="transmf_ad_tpu/ops/flash_attention.py:78")

_FLASH_SOURCE = "transmf_ad_tpu_torch/csrc/flash_attention.cu"
_FLASH_SIZES = (INT, INT, INT, INT, FLOAT, INT)  # BH, N, M, D, scale, dtype
FLASH_FWD = Kernel(
    name="flash_fwd", entry="transmf_flash_fwd",
    argtypes=(PTR,) * 5 + _FLASH_SIZES, source=_FLASH_SOURCE,
    replaces="transmf_ad_tpu/ops/flash_attention.py:222")
FLASH_DQ = Kernel(
    name="flash_dq", entry="transmf_flash_dq",
    argtypes=(PTR,) * 7 + _FLASH_SIZES, source=_FLASH_SOURCE,
    replaces="transmf_ad_tpu/ops/flash_attention.py:343")
FLASH_DKV = Kernel(
    name="flash_dkv", entry="transmf_flash_dkv",
    argtypes=(PTR,) * 8 + _FLASH_SIZES, source=_FLASH_SOURCE,
    replaces="transmf_ad_tpu/ops/flash_attention.py:361")

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


def _check_qkv(name: str, q, k, v, *same_as_q):
    """Validate CUDA inputs of an attention kernel; returns (BH, N, M, D)
    and the dtype code."""
    dtype = check_cuda(name, q, k, v, *same_as_q)
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 \
            or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3] \
            or any(t.shape != q.shape for t in same_as_q):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    b, h, n, d = q.shape
    if d > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {d} > {MAX_HEAD_DIM}")
    return (b * h, n, k.shape[2], d), dtype


def _attention(q, k, v, scale: float) -> torch.Tensor:
    if q.device.type == "cpu":
        return attention_reference(q, k, v, scale)
    sizes, dtype = _check_qkv("fused_attention", q, k, v)
    out = torch.empty_like(q)
    ATTENTION.launch(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), *sizes, float(scale), dtype)
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


def flash_fwd_reference(q, k, v, scale: float):
    """(out, lse): softmax(q k^T * scale) v in float32, rounded once to q's
    dtype, and the float32 logsumexp of every row of q k^T * scale.
    q: (..., N, D), k/v: (..., M, D); lse: (..., N)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse.unsqueeze(-1))
    return torch.matmul(p, v.float()).to(q.dtype), lse


def flash_delta(o, g) -> torch.Tensor:
    """rowsum(g * o) in float32, (..., N): the softmax backward's row term,
    taken from the rounded output as the JAX package takes it."""
    return (g.float() * o.float()).sum(dim=-1)


def _p_ds(q, k, v, g, lse, delta, scale: float):
    """float32 p = exp(q k^T * scale - lse) and ds = p * (g v^T - delta)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.exp(s - lse.unsqueeze(-1))
    dp = torch.matmul(g.float(), v.float().transpose(-1, -2))
    return p, p * (dp - delta.unsqueeze(-1))


def flash_dq_reference(q, k, v, g, lse, delta, scale: float):
    """dq = (ds k) * scale in float32, rounded once to q's dtype."""
    _, ds = _p_ds(q, k, v, g, lse, delta, scale)
    return (torch.matmul(ds, k.float()) * scale).to(q.dtype)


def _dkv(p, ds, q, k, v, g, scale):
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    dv = torch.matmul(p.transpose(-1, -2), g.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_dkv_reference(q, k, v, g, lse, delta, scale: float):
    """(dk, dv) = (ds^T q * scale, p^T g) in float32, each rounded once."""
    return _dkv(*_p_ds(q, k, v, g, lse, delta, scale), q, k, v, g, scale)


def flash_bwd_reference(q, k, v, o, lse, g, scale: float):
    """(dq, dk, dv) for the output gradient g from the saved output and
    logsumexp: p = exp(s - lse), ds = p * (g v^T - rowsum(g * o)); float32,
    each gradient rounded once to its input's dtype."""
    p, ds = _p_ds(q, k, v, g, lse, flash_delta(o, g), scale)
    dq = (torch.matmul(ds, k.float()) * scale).to(q.dtype)
    return (dq, *_dkv(p, ds, q, k, v, g, scale))


def flash_fwd(q, k, v, scale: float):
    """(out, lse) of `flash_fwd_reference`: kernel K10 on CUDA tensors
    (D <= 128, any N and M), the plain version on CPU tensors."""
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, scale)
    sizes, dtype = _check_qkv("flash_attention", q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    FLASH_FWD.launch(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), lse.data_ptr(), *sizes, float(scale),
                     dtype)
    return out, lse


def _check_bwd(name: str, q, k, v, g, lse, delta):
    """`_check_qkv` plus the two float32 (B, H, N) row vectors; returns the
    six input pointers, the sizes and the dtype code."""
    sizes, dtype = _check_qkv(name, q, k, v, g)
    for what, t in (("lse", lse), ("delta", delta)):
        if t.shape != q.shape[:3] or t.dtype != torch.float32 \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be a contiguous float32 "
                             f"{tuple(q.shape[:3])} tensor on {q.device}")
    return tuple(t.data_ptr() for t in (q, k, v, g, lse, delta)), sizes, dtype


def flash_dq(q, k, v, g, lse, delta, scale: float):
    """dq of `flash_dq_reference`: kernel K11 on CUDA tensors, the plain
    version on CPU tensors. lse, delta: float32 (B, H, N)."""
    if q.device.type == "cpu":
        return flash_dq_reference(q, k, v, g, lse, delta, scale)
    ins, sizes, dtype = _check_bwd("flash_dq", q, k, v, g, lse, delta)
    dq = torch.empty_like(q)
    FLASH_DQ.launch(q.device, *ins, dq.data_ptr(), *sizes, float(scale),
                    dtype)
    return dq


def flash_dkv(q, k, v, g, lse, delta, scale: float):
    """(dk, dv) of `flash_dkv_reference`: kernel K12 on CUDA tensors, the
    plain version on CPU tensors. lse, delta: float32 (B, H, N)."""
    if q.device.type == "cpu":
        return flash_dkv_reference(q, k, v, g, lse, delta, scale)
    ins, sizes, dtype = _check_bwd("flash_dkv", q, k, v, g, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    FLASH_DKV.launch(q.device, *ins, dk.data_ptr(), dv.data_ptr(), *sizes,
                     float(scale), dtype)
    return dk, dv


def flash_bwd(q, k, v, o, lse, g, scale: float):
    """(dq, dk, dv) of `flash_bwd_reference`: kernels K11 and K12 on CUDA
    tensors, the plain version on CPU tensors."""
    if q.device.type == "cpu":
        return flash_bwd_reference(q, k, v, o, lse, g, scale)
    delta = flash_delta(o, g)
    return (flash_dq(q, k, v, g, lse, delta, scale),
            *flash_dkv(q, k, v, g, lse, delta, scale))


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = flash_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        return (*flash_bwd(*ctx.saved_tensors, g.contiguous(), ctx.scale),
                None)


def flash_attention(q, k, v, scale: float) -> torch.Tensor:
    """q: (B, H, N, D), k/v: (B, H, M, D) -> (B, H, N, D). Kernel K10 on CUDA
    tensors, with K11 and K12 as its backward; on CPU tensors the plain
    versions, whose backward also goes through the saved logsumexp."""
    return _Flash.apply(q, k, v, scale)
