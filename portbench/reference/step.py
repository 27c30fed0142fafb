"""The plain train step the benchmark holds the program to.

Train step, per batch: each sample's volumes augmented by one draw
(`augment.draw`, then the model's dropout draws from the same generator),
the forward with BatchNorm batch moments, the loss (cross-entropy, plus
for an adversarial model the mean of the two discriminator
cross-entropies with MRI labelled 1 and PET 0), the backward, and Adam
(beta 0.9 / 0.999, eps 1e-8, no weight decay, bias-corrected), all in
float32 (or through the control's fp8 rounding). `train` returns each
step's loss, the first step's gradients, the parameters after the steps
and the first step's outputs.
"""

from __future__ import annotations

import importlib

import torch

from . import augment
from .layers import Precision

BETAS, ADAM_EPS = (0.9, 0.999), 1e-8


def module(name: str):
    """The reference module a configuration names (`"reference"`)."""
    return importlib.import_module(f"{__package__}.{name}")


def build(cfg: dict, device):
    """The configuration's reference model on `device`, float32."""
    return module(cfg["reference"]).Model(**cfg["model"]).to(device)


def _inputs(batch, params, prec):
    """(B, X, Y, Z) volumes -> augmented float32 (B, 1, X, Y, Z)."""
    out = []
    for name in ("MRI", "PET"):
        v = batch[name].float()
        if params is not None:
            v = torch.stack([augment.augment(v[i], p)
                             for i, p in enumerate(params)])
        out.append(v[:, None])
    return out


def loss_of(model, out, labels, adversarial: bool):
    f = torch.nn.functional.cross_entropy
    if not adversarial:
        return f(out, labels)
    logits, d_mri, d_pet = out
    ones = torch.ones_like(labels)
    return f(logits, labels) + (f(d_mri, ones) + f(d_pet, 0 * ones)) / 2.0


def train(model, adversarial: bool, batches, generator, aug_cfg, lr,
          prec: Precision = Precision()):
    """Run the steps on `batches` (dicts of 'MRI', 'PET' (B, X, Y, Z) and
    'label' (B,)); returns (losses, first-step gradients, parameters
    after, first-step outputs): the gradients and parameters by name, the
    outputs as the model returns them (logits, d_mri, d_pet or logits),
    float32."""
    params = dict(model.named_parameters())
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    losses, first, outputs = [], None, None
    for t, batch in enumerate(batches, start=1):
        n = batch["label"].shape[0]
        draws = (augment.draw(generator, n, aug_cfg) if aug_cfg is not None
                 else None)
        mri, pet = _inputs(batch, draws, prec)
        out = model(mri, pet, True, generator, prec)
        if outputs is None:
            outputs = [o.detach().clone()
                       for o in (out if adversarial else (out,))]
        loss = loss_of(model, out, batch["label"].long(), adversarial)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        del out, mri, pet
        losses.append(float(loss.detach()))
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(params.items(), grads)}
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        with torch.no_grad():
            for k, p in params.items():
                g = grads[k]
                m[k].mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                v[k].mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                mhat = m[k] / (1 - BETAS[0] ** t)
                vhat = v[k] / (1 - BETAS[1] ** t)
                p.sub_(lr * mhat / (vhat.sqrt() + ADAM_EPS))
        del grads
    after = {k: p.detach().clone() for k, p in params.items()}
    return losses, first, after, outputs

