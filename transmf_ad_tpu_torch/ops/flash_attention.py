"""Single-pass attention and KV-blocked flash attention.

Port of transmf_ad_tpu/ops/flash_attention.py. `fused_attention`: the forward
is kernel K2 (csrc/attention.cu); the backward is a plain float32 recompute,
as the JAX package's is XLA (`_bwd_reference`). K2 has two variants, and
`attention_variant(dtype, d)` names the one a CUDA launch takes: "mma"
(FlashAttention-2 tiling on the tensor cores) for bfloat16 with a head dim of
16, 32, 64 or 128; "rows" (K10's resident-row forward on the CUDA cores,
without the logsumexp) for float32 and other head dims. The choice depends on
dtype and head dim alone; `ATTENTION.by_variant` counts the launches of each.
`flash_attention`, which `attention_core` takes above `FLASH_MIN_KEYS` keys:
the forward is K10 and saves the float32 logsumexp of every query row; the
backward is K11 (dq) and K12 (dk, dv), which recompute the probabilities from
that logsumexp (csrc/flash_attention.cu). K10 has K2's two variants by K2's
rule (`attention_variant`): "mma", K2's tensor-core forward with the
logsumexp store (csrc/attention_mma.cuh), and "rows". K11 and K12 have the
same two by `flash_bwd_variant`: "mma" (FlashAttention-2's backward on the
tensor cores, csrc/flash_bwd_mma.cuh) for bfloat16 with a head dim of 16, 32
or 64, "rows" (the CUDA cores) for float32 and other head dims.
`FLASH_FWD.by_variant`, `FLASH_DQ.by_variant` and `FLASH_DKV.by_variant`
count them. The TPU kernels' `block_q`/`block_k` arguments tile VMEM and
have no counterpart here. The ops: `transmf::attention` (K2),
`flash_fwd` (K10, differentiable in both outputs: a gradient of the
logsumexp joins the softmax backward's row term), `flash_dq` (K11) and
`flash_dkv` (K12).
"""

from __future__ import annotations

import torch

from .._build import FLOAT, INT, PTR, Kernel, check_cuda, define_op

FLASH_MIN_KEYS = 2048  # above this `attention_core` takes flash_attention

ATTENTION = Kernel(
    name="attention_fwd", entry="transmf_attention_fwd",
    argtypes=(PTR, PTR, PTR, PTR, INT, INT, INT, INT, FLOAT, INT, INT),
    source="transmf_ad_tpu_torch/csrc/attention.cu",
    replaces="transmf_ad_tpu/ops/flash_attention.py:78")
ATTENTION_VARIANTS = ("rows", "mma")  # K2's and K10-K12's, by their C code
MMA_HEAD_DIMS = (16, 32, 64, 128)
BWD_MMA_HEAD_DIMS = (16, 32, 64)  # K11, K12: at 128 the registers run out

_FLASH_SOURCE = "transmf_ad_tpu_torch/csrc/flash_attention.cu"
_FLASH_SIZES = (INT, INT, INT, INT, FLOAT, INT)  # BH, N, M, D, scale, dtype
FLASH_FWD = Kernel(
    name="flash_fwd", entry="transmf_flash_fwd",
    argtypes=(PTR,) * 5 + _FLASH_SIZES + (INT,), source=_FLASH_SOURCE,
    replaces="transmf_ad_tpu/ops/flash_attention.py:222")
FLASH_DQ = Kernel(
    name="flash_dq", entry="transmf_flash_dq",
    argtypes=(PTR,) * 7 + _FLASH_SIZES + (INT,), source=_FLASH_SOURCE,
    replaces="transmf_ad_tpu/ops/flash_attention.py:343")
FLASH_DKV = Kernel(
    name="flash_dkv", entry="transmf_flash_dkv",
    argtypes=(PTR,) * 8 + _FLASH_SIZES + (INT,), source=_FLASH_SOURCE,
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


def attention_variant(dtype: torch.dtype, d: int) -> str:
    """The K2 and K10 variant a CUDA launch takes: "mma" (tensor cores) or
    "rows" (CUDA cores), from the dtype and the head dim alone."""
    if dtype == torch.bfloat16 and d in MMA_HEAD_DIMS:
        return "mma"
    return "rows"


def flash_bwd_variant(dtype: torch.dtype, d: int) -> str:
    """The K11 and K12 variant a CUDA launch takes: "mma" (tensor cores) or
    "rows" (CUDA cores), from the dtype and the head dim alone."""
    if dtype == torch.bfloat16 and d in BWD_MMA_HEAD_DIMS:
        return "mma"
    return "rows"


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


def _attention_launch(q, k, v, scale: float) -> torch.Tensor:
    """K2 on CUDA tensors, in the variant `attention_variant` names."""
    sizes, dtype = _check_qkv("fused_attention", q, k, v)
    which = attention_variant(q.dtype, q.shape[3])
    out = torch.empty_like(q)
    ATTENTION.launch(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), *sizes, float(scale), dtype,
                     ATTENTION_VARIANTS.index(which), variant=which)
    return out


def _attention_setup(ctx, inputs, output):
    q, k, v, ctx.scale = inputs
    ctx.save_for_backward(q, k, v)


def _attention_backward(ctx, g):
    return (*attention_bwd_reference(*ctx.saved_tensors, g.contiguous(),
                                     ctx.scale), None)


attention_op = define_op(
    "attention(Tensor q, Tensor k, Tensor v, float scale) -> Tensor",
    attention_reference, _attention_launch,
    lambda q, k, v, scale: torch.empty_like(q), _attention_backward,
    _attention_setup)


def _attention(q, k, v, scale: float) -> torch.Tensor:
    return attention_op(q, k, v, scale)


def fused_attention(q, k, v, scale: float) -> torch.Tensor:
    """q: (B, H, N, D), k/v: (B, H, M, D) -> (B, H, N, D). Kernel K2 on CUDA
    tensors (D <= 128, any M; the variant `attention_variant` names); the
    plain version on CPU tensors. Differentiable, with a plain backward."""
    return _attention(q, k, v, scale)


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


def _flash_fwd_launch(q, k, v, scale: float):
    """K10 on CUDA tensors, in the variant `attention_variant` names."""
    sizes, dtype = _check_qkv("flash_attention", q, k, v)
    which = attention_variant(q.dtype, q.shape[3])
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    FLASH_FWD.launch(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), lse.data_ptr(), *sizes, float(scale),
                     dtype, ATTENTION_VARIANTS.index(which), variant=which)
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


def _flash_dq_launch(q, k, v, g, lse, delta, scale: float):
    """K11 on CUDA tensors, in the variant `flash_bwd_variant` names."""
    ins, sizes, dtype = _check_bwd("flash_dq", q, k, v, g, lse, delta)
    which = flash_bwd_variant(q.dtype, q.shape[3])
    dq = torch.empty_like(q)
    FLASH_DQ.launch(q.device, *ins, dq.data_ptr(), *sizes, float(scale),
                    dtype, ATTENTION_VARIANTS.index(which), variant=which)
    return dq


def _flash_dkv_launch(q, k, v, g, lse, delta, scale: float):
    """K12 on CUDA tensors, in the variant `flash_bwd_variant` names."""
    ins, sizes, dtype = _check_bwd("flash_dkv", q, k, v, g, lse, delta)
    which = flash_bwd_variant(q.dtype, q.shape[3])
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    FLASH_DKV.launch(q.device, *ins, dk.data_ptr(), dv.data_ptr(), *sizes,
                     float(scale), dtype, ATTENTION_VARIANTS.index(which),
                     variant=which)
    return dk, dv


def _flash_fwd_setup(ctx, inputs, output):
    q, k, v, ctx.scale = inputs
    ctx.save_for_backward(q, k, v, *output)
    ctx.set_materialize_grads(False)  # an unused output's gradient is None


def _flash_fwd_backward(ctx, g, g_lse):
    """K11 and K12 from the saved output and logsumexp. A gradient of the
    logsumexp enters the row term: d lse / d s = p, so ds = p * (dp -
    (delta - g_lse))."""
    q, k, v, o, lse = ctx.saved_tensors
    g = torch.zeros_like(o) if g is None else g.contiguous()
    delta = flash_delta(o, g)
    if g_lse is not None:
        delta = delta - g_lse
    return (flash_dq(q, k, v, g, lse, delta, ctx.scale),
            *flash_dkv(q, k, v, g, lse, delta, ctx.scale), None)


_QKV = "Tensor q, Tensor k, Tensor v"
_ROWS = "Tensor g, Tensor lse, Tensor delta, float scale"
flash_fwd_op = define_op(
    f"flash_fwd({_QKV}, float scale) -> (Tensor, Tensor)",
    flash_fwd_reference, _flash_fwd_launch,
    lambda q, k, v, scale: (torch.empty_like(q),
                            q.new_empty(q.shape[:3], dtype=torch.float32)),
    _flash_fwd_backward, _flash_fwd_setup)
flash_dq_op = define_op(
    f"flash_dq({_QKV}, {_ROWS}) -> Tensor", flash_dq_reference,
    _flash_dq_launch, lambda q, *_: torch.empty_like(q))
flash_dkv_op = define_op(
    f"flash_dkv({_QKV}, {_ROWS}) -> (Tensor, Tensor)", flash_dkv_reference,
    _flash_dkv_launch,
    lambda q, k, v, *_: (torch.empty_like(k), torch.empty_like(v)))


def flash_fwd(q, k, v, scale: float):
    """(out, lse) of `flash_fwd_reference`: kernel K10 on CUDA tensors
    (D <= 128, any N and M; the variant `attention_variant` names), the
    plain version on CPU tensors. Differentiable in both outputs, with K11
    and K12 as its backward."""
    return flash_fwd_op(q, k, v, scale)


def flash_dq(q, k, v, g, lse, delta, scale: float):
    """dq of `flash_dq_reference`: kernel K11 on CUDA tensors (the variant
    `flash_bwd_variant` names), the plain version on CPU tensors. lse,
    delta: float32 (B, H, N)."""
    return flash_dq_op(q, k, v, g, lse, delta, scale)


def flash_dkv(q, k, v, g, lse, delta, scale: float):
    """(dk, dv) of `flash_dkv_reference`: kernel K12 on CUDA tensors (the
    variant `flash_bwd_variant` names), the plain version on CPU tensors.
    lse, delta: float32 (B, H, N)."""
    return flash_dkv_op(q, k, v, g, lse, delta, scale)


def flash_bwd(q, k, v, o, lse, g, scale: float):
    """(dq, dk, dv) of `flash_bwd_reference`: kernels K11 and K12 on CUDA
    tensors, the plain versions on CPU tensors."""
    delta = flash_delta(o, g)
    return (flash_dq(q, k, v, g, lse, delta, scale),
            *flash_dkv(q, k, v, g, lse, delta, scale))


def flash_attention(q, k, v, scale: float) -> torch.Tensor:
    """q: (B, H, N, D), k/v: (B, H, M, D) -> (B, H, N, D). Kernel K10 on CUDA
    tensors, with K11 and K12 as its backward; on CPU tensors the plain
    versions, whose backward also goes through the saved logsumexp."""
    return flash_fwd(q, k, v, scale)[0]
