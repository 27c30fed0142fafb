"""Fused GAP/GMP token pooling head.

Port of transmf_ad_tpu/ops/pooling.py: the fusion head concatenates
[mean(mri), mean(pet), max(mri), max(pet)] over the token axis in one pass
(kernel K1, csrc/token_pool.cu). Forward only; the backward is still to port.
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


def fused_token_pool(mri: torch.Tensor, pet: torch.Tensor) -> torch.Tensor:
    """(B, N, D) x 2 -> (B, 4D). Kernel K1 on CUDA tensors; the plain
    version on CPU tensors."""
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
