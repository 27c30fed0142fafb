"""Fused GAP/GMP token pooling head.

Port of transmf_ad_tpu/ops/pooling.py: the fusion head concatenates
[mean(mri), mean(pet), max(mri), max(pet)] over the token axis in one pass
(kernel K1, csrc/token_pool.cu). The backward is plain PyTorch, as the JAX
package's is XLA: g/N for the means, and the max gradient split equally over
tied argmax tokens.
"""

from __future__ import annotations

import torch

from .._build import INT, PTR, Kernel, check_cuda

TOKEN_POOL = Kernel(
    name="token_pool", entry="transmf_token_pool",
    argtypes=(PTR, PTR, PTR, INT, INT, INT, INT),
    source="transmf_ad_tpu_torch/csrc/token_pool.cu",
    replaces="transmf_ad_tpu/ops/pooling.py:37")


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


def _token_pool(mri: torch.Tensor, pet: torch.Tensor) -> torch.Tensor:
    if mri.device.type == "cpu":
        return pool_reference(mri, pet)
    dtype = check_cuda("fused_token_pool", mri, pet)
    if mri.dim() != 3 or pet.shape != mri.shape:
        raise ValueError(f"fused_token_pool: shapes {tuple(mri.shape)} and "
                         f"{tuple(pet.shape)}, expected two equal (B, N, D)")
    b, n, d = mri.shape
    out = torch.empty(b, 4 * d, dtype=mri.dtype, device=mri.device)
    TOKEN_POOL.launch(mri.device, mri.data_ptr(), pet.data_ptr(),
                      out.data_ptr(), b, n, d, dtype)
    return out


class _TokenPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mri, pet):
        ctx.save_for_backward(mri, pet)
        return _token_pool(mri, pet)

    @staticmethod
    def backward(ctx, g):
        return pool_bwd_reference(*ctx.saved_tensors, g.contiguous())


def fused_token_pool(mri: torch.Tensor, pet: torch.Tensor) -> torch.Tensor:
    """(B, N, D) x 2 -> (B, 4D). Kernel K1 on CUDA tensors; the plain
    version on CPU tensors. Differentiable, with a plain backward."""
    return _TokenPool.apply(mri, pet)
