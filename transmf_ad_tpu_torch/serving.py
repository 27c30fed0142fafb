"""Serving: an eval-mode forward closed over a model: volumes -> probabilities.

Port of transmf_ad_tpu/serving.py::make_inference_fn for the adversarial
paper model. Export and load of a serialized artifact are still to port.
"""

from __future__ import annotations

import torch


def resolve_dtype(dtype, device: torch.device) -> torch.dtype:
    """'auto' -> bfloat16 on CUDA, float32 elsewhere (the JAX package's
    `--dtype auto` picks bfloat16 on its accelerator); a torch.dtype is
    taken as it is."""
    if dtype == "auto":
        return torch.bfloat16 if device.type == "cuda" else torch.float32
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"dtype must be 'auto' or a torch.dtype, got "
                         f"{dtype!r}")
    return dtype


def make_inference_fn(model, device="cuda", dtype="auto"):
    """Move `model` to `device` in eval mode and return fn(mri, pet): two
    (B, X, Y, Z) volumes (tensors or arrays) -> (B, 2) float32 softmax
    probabilities on `device`. The forward computes in `dtype` with the
    model's float32 parameters."""
    device = torch.device(device)
    dt = resolve_dtype(dtype, device)
    model = model.to(device).eval()

    @torch.inference_mode()
    def infer(mri, pet):
        vols = [torch.as_tensor(v).to(device=device, dtype=dt)[..., None]
                for v in (mri, pet)]
        logits = model(*vols)[0]
        return torch.softmax(logits.float(), dim=-1)

    return infer
