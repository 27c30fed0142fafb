"""Fused GAP/GMP token pooling head.

Port of transmf_ad_tpu/ops/pooling.py: the fusion head concatenates
[mean(mri), mean(pet), max(mri), max(pet)] over the token axis in one pass
(kernel K1, csrc/token_pool.cu), registered as the op `transmf::token_pool`.
The backward is plain PyTorch, as the JAX package's is XLA: g/N for the
means, and the max gradient split equally over tied argmax tokens.

K1 has two variants, chosen by `variant(dtype, shape)` alone: "cluster"
(a thread-block cluster of 8 blocks per batch row, 16-byte loads;
`cluster_plan` gives its split of the tokens) wherever a token row is a
whole number of 16-byte pieces, at most 256 of them, which holds for the
models' widths in bfloat16 and float32; "column" (one thread per (b, d))
otherwise.
"""

from __future__ import annotations

import torch

from .._build import (INT, PTR, Kernel, check_cuda, define_op,
                      save_inputs)

TOKEN_POOL = Kernel(
    name="token_pool", entry="transmf_token_pool",
    argtypes=(PTR, PTR, PTR, INT, INT, INT, INT, INT),
    source="transmf_ad_tpu_torch/csrc/token_pool.cu",
    replaces="transmf_ad_tpu/ops/pooling.py:37")
VARIANTS = ("column", "cluster")  # by their code in C
VEC_BYTES = 16
CLUSTER_THREADS = 256  # a "cluster" block (kClusterThreads in C)
CLUSTER_SIZE = 8  # blocks of a cluster (kClusterSize)


def variant(dtype: torch.dtype, shape) -> str:
    """The K1 variant a CUDA launch takes for (B, N, D) tensors of `dtype`:
    "cluster" where a token row of D channels is a whole number of 16-byte
    pieces, at most CLUSTER_THREADS of them (bfloat16 D % 8 == 0, float32
    D % 4 == 0), else "column"."""
    pieces, rest = divmod(shape[-1] * dtype.itemsize, VEC_BYTES)
    return "cluster" if rest == 0 and pieces <= CLUSTER_THREADS else "column"


def cluster_plan(dtype: torch.dtype, n: int, d: int) -> tuple[int, int]:
    """(R, chunk) of a "cluster" launch: R token rows in flight a block
    (CLUSTER_THREADS over the 16-byte pieces of a row), and the tokens
    [rank * chunk, (rank + 1) * chunk) of block `rank` of the CLUSTER_SIZE
    blocks of a batch row, the last ones short or empty."""
    r = CLUSTER_THREADS // (d * dtype.itemsize // VEC_BYTES)
    return r, -(-n // CLUSTER_SIZE)


def pool_reference(mri: torch.Tensor, pet: torch.Tensor) -> torch.Tensor:
    """concat[mean(mri), mean(pet), max(mri), max(pet)] over tokens, in
    float32, rounded once to the input dtype."""
    m, p = mri.float(), pet.float()
    out = torch.cat([m.mean(1), p.mean(1), m.amax(1), p.amax(1)], dim=-1)
    return out.to(mri.dtype)


def pool_bwd_reference(mri, pet, g):
    """Gradients of `pool_reference` for its output gradient g (B, 4D), as
    the JAX package's `_bwd` writes them, in g's dtype."""
    n, d = mri.shape[1], mri.shape[2]

    def back(x, g_mean, g_max):
        is_max = (x == x.amax(dim=1, keepdim=True)).to(g.dtype)
        is_max = is_max / is_max.sum(dim=1, keepdim=True)
        return (g_mean[:, None, :] / n + is_max * g_max[:, None, :]).to(x.dtype)

    return (back(mri, g[:, :d], g[:, 2 * d:3 * d]),
            back(pet, g[:, d:2 * d], g[:, 3 * d:]))


def _token_pool_launch(mri: torch.Tensor, pet: torch.Tensor) -> torch.Tensor:
    """K1 on CUDA tensors, in the variant `variant` names."""
    dtype = check_cuda("fused_token_pool", mri, pet)
    if mri.dim() != 3 or pet.shape != mri.shape:
        raise ValueError(f"fused_token_pool: shapes {tuple(mri.shape)} and "
                         f"{tuple(pet.shape)}, expected two equal (B, N, D)")
    b, n, d = mri.shape
    which = variant(mri.dtype, mri.shape)
    out = torch.empty(b, 4 * d, dtype=mri.dtype, device=mri.device)
    if which == "cluster":
        for t in (mri, pet, out):
            if t.data_ptr() % VEC_BYTES:
                raise ValueError("fused_token_pool: \"cluster\" needs 16-byte "
                                 f"aligned tensors; one starts at "
                                 f"{t.data_ptr():#x}")
    TOKEN_POOL.launch(mri.device, mri.data_ptr(), pet.data_ptr(),
                      out.data_ptr(), b, n, d, dtype, VARIANTS.index(which),
                      variant=which)
    return out


def _token_pool_fake(mri, pet):
    return mri.new_empty(mri.shape[0], 4 * mri.shape[2])


def _token_pool_backward(ctx, g):
    return pool_bwd_reference(*ctx.saved_tensors, g.contiguous())


token_pool_op = define_op(
    "token_pool(Tensor mri, Tensor pet) -> Tensor", pool_reference,
    _token_pool_launch, _token_pool_fake, _token_pool_backward,
    save_inputs)


def fused_token_pool(mri: torch.Tensor, pet: torch.Tensor) -> torch.Tensor:
    """(B, N, D) x 2 -> (B, 4D). Kernel K1 on CUDA tensors; the plain
    version on CPU tensors. Differentiable, with a plain backward."""
    return token_pool_op(mri, pet)
