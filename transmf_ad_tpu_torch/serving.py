"""Serving: an eval-mode forward closed over a model: volumes -> probabilities.

Port of transmf_ad_tpu/serving.py::make_inference_fn. Export and load of a
serialized artifact are still to port.
"""

from __future__ import annotations

from typing import Optional

import torch

from .models import ADVERSARIAL, model_name


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


def make_inference_fn(model, device="cuda", dtype="auto",
                      adversarial: Optional[bool] = None):
    """Move `model` to `device` in eval mode and return fn(*vols): one
    (B, X, Y, Z) volume (tensor or array) per modality of the model, each
    given a trailing channel axis, -> (B, 2) float32 softmax probabilities
    on `device`; a wrong number of volumes raises from the model's forward.
    The forward computes in `dtype` with the model's float32 parameters. An
    adversarial model returns (logits, d_mri, d_pet) and the logits are
    taken from it; any other returns the logits.
    `adversarial` is read from the registry (`models.ADVERSARIAL`) unless it
    is given, as it must be for a model the registry does not hold."""
    device = torch.device(device)
    if adversarial is None:
        adversarial = model_name(model) in ADVERSARIAL
    dt = resolve_dtype(dtype, device)
    model = model.to(device).eval()

    @torch.inference_mode()
    def infer(*vols):
        vols = [torch.as_tensor(v).to(device=device, dtype=dt)[..., None]
                for v in vols]
        out = model(*vols, train=False)
        logits = out[0] if adversarial else out
        return torch.softmax(logits.float(), dim=-1)

    return infer
