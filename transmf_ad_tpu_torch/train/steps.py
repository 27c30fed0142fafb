"""The train step and its state.

Port of transmf_ad_tpu/train/steps.py::make_train_step for one device. The
JAX step is one jitted program; here the same work runs eagerly on the
model's device: dequantize and augment the batch, forward with BatchNorm
statistic updates and dropout, the triple loss (CE + the mean of the two
discriminator CEs, with masked sums), backward, the optimizer step and the
scheduler step. The multi-device (`mesh`) form, buffer donation and the eval
step are still to port (ROADMAP.md Queue 1 items 4 and 8).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
from torch import nn

from ..data.transforms import AugmentConfig, augment, draw_params
from ..nn.losses import cross_entropy
from ..serving import resolve_dtype
from .optim import build_optimizer


@dataclasses.dataclass
class TrainState:
    """Model (float32 master parameters), optimizer, scheduler, the
    generator that augmentation and dropout draw from, the compute dtype of
    the forward, and the number of steps taken."""
    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    generator: torch.Generator
    dtype: torch.dtype = torch.float32
    step: int = 0


def create_state(model: nn.Module, device="cpu", dtype="auto", seed: int = 0,
                 **optim_kw) -> TrainState:
    """Move `model` to `device` and build its optimizer (`build_optimizer`
    keywords) and a generator seeded with `seed` on that device. dtype:
    'auto' (bfloat16 on CUDA, float32 elsewhere) or a torch.dtype."""
    device = torch.device(device)
    model.to(device)
    opt, sched = build_optimizer(model.parameters(), **optim_kw)
    gen = torch.Generator(device=device).manual_seed(seed)
    return TrainState(model, opt, sched, gen, resolve_dtype(dtype, device))


def dequantize_input(v: torch.Tensor) -> torch.Tensor:
    """Undo the host feed's uint8 quantization (q = round(255 * x) of the
    [0, 1]-normalised volume); other inputs pass through untouched."""
    if v.dtype == torch.uint8:
        return v.float() * (1.0 / 255.0)
    return v


def _prep_inputs(batch, modalities: Sequence[str],
                 aug_cfg: Optional[AugmentConfig], generator, device, dtype):
    """Dequantize, augment (one draw per sample, shared by its modalities),
    cast to the compute dtype and add the channel axis:
    (B, X, Y, Z) -> (B, X, Y, Z, 1)."""
    vols = {k: dequantize_input(torch.as_tensor(batch[k]).to(device))
            for k in modalities}
    if aug_cfg is not None:
        n = vols[modalities[0]].shape[0]
        samples = [augment({k: v[i] for k, v in vols.items()}, params,
                           aug_cfg)
                   for i, params in enumerate(draw_params(generator, aug_cfg,
                                                          n))]
        vols = {k: torch.stack([s[k] for s in samples]) for k in modalities}
    return [vols[k].to(dtype)[..., None] for k in modalities]


def _ce_sums(logits, labels, weights=None, mask=None):
    """Cross-entropy as (weighted NLL sum, weight sum), whose ratio is the
    torch-style (weighted) mean; `mask` (B,) zeroes padded samples."""
    nll = cross_entropy(logits, labels, weights, reduce=False)
    if weights is None:
        w = torch.ones(labels.shape[0], dtype=torch.float32,
                       device=logits.device)
    else:
        w = torch.as_tensor(weights, dtype=torch.float32,
                            device=logits.device)[labels.long()]
    if mask is not None:
        nll = nll * mask
        w = w * mask
    return nll.sum(), w.sum()


def make_train_step(modalities: Sequence[str] = ("MRI", "PET"),
                    adversarial: bool = True,
                    aug_cfg: Optional[AugmentConfig] = None,
                    class_weights=None, mask_bn: bool = False):
    """Returns step(state, batch) -> aux. `batch` maps each modality to a
    (B, X, Y, Z) volume batch (float or uint8), 'label' to (B,) class
    indices and, optionally, 'mask' to (B,) 0/1 weights of real samples.
    The step updates `state` in place and returns detached `loss`,
    `ce_loss`, `ad_loss`, `logits`, `d_mri`, `d_pet` (adversarial),
    `label` and `mask`.

    mask_bn=True feeds the mask into every BatchNorm's batch moments, so a
    duplicate-padded batch trains like its real samples alone."""
    modalities = tuple(modalities)

    def step(state: TrainState, batch) -> dict:
        model = state.model
        device = next(model.parameters()).device
        inputs = _prep_inputs(batch, modalities, aug_cfg, state.generator,
                              device, state.dtype)
        labels = torch.as_tensor(batch["label"]).to(device).long()
        mask = batch.get("mask")
        if mask is not None:
            mask = torch.as_tensor(mask, dtype=torch.float32).to(device)
        bn_mask = mask if mask_bn else None

        out = model(*inputs, train=True, bn_mask=bn_mask,
                    generator=state.generator)
        if adversarial:
            logits, d_mri, d_pet = out
            b = labels.shape[0]
            ce_n, ce_d = _ce_sums(logits, labels, class_weights, mask)
            # discriminator: MRI labeled 1, PET labeled 0, averaged
            # (reference: kfold_train_adversarial.py:120-125)
            ones = torch.ones(b, dtype=torch.long, device=device)
            mri_n, n = _ce_sums(d_mri, ones, mask=mask)
            pet_n, _ = _ce_sums(d_pet, torch.zeros_like(ones), mask=mask)
            ce = ce_n / ce_d
            ad = (mri_n / n + pet_n / n) / 2.0
            loss = ce + ad
            aux = {"logits": logits, "d_mri": d_mri, "d_pet": d_pet,
                   "ce_loss": ce, "ad_loss": ad}
        else:
            logits = out
            ce_n, ce_d = _ce_sums(logits, labels, class_weights, mask)
            loss = ce_n / ce_d
            aux = {"logits": logits, "ce_loss": loss,
                   "ad_loss": torch.zeros((), device=device)}

        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        aux = {k: v.detach() for k, v in aux.items()}
        aux["loss"] = loss.detach()
        aux["label"] = labels
        aux["mask"] = (mask if mask is not None
                       else torch.ones(labels.shape[0], device=device))
        return aux

    return step
