"""Losses: the cross-entropy the training drivers use, the adversarial
loss of the train step, and the SupCon and feature-affinity losses.

Port of transmf_ad_tpu/nn/losses.py (torch CrossEntropyLoss semantics,
float32). SupCon and feature affinity are library losses no driver calls,
as in the reference (reference: models/losses.py:13-128).
"""

from __future__ import annotations

import torch

from ..parallel.distributed import psum


def cross_entropy(logits, labels, weights=None, reduce: bool = True):
    """Softmax cross-entropy over integer labels, in float32.

    weights: optional per-class weights; the mean is then the weighted mean
    sum(w_i * nll_i) / sum(w_i). reduce=False returns the per-sample NLL
    (weights applied, no normalisation) for masked accumulation."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels.long()[:, None])[:, 0]
    if weights is None:
        return nll.mean() if reduce else nll
    w = torch.as_tensor(weights, dtype=torch.float32,
                        device=logits.device)[labels.long()]
    if not reduce:
        return w * nll
    return (w * nll).sum() / w.sum()


def adversarial_loss(d_mri_logits, d_pet_logits, mask=None, group=None):
    """Discriminator loss: MRI labeled 1, PET labeled 0, the two mean
    cross-entropies averaged (reference: kfold_train_adversarial.py:
    120-125). mask: optional (B,) 0/1 weights of real samples, whose
    weighted means then replace the means. group: a process group whose
    ranks each hold rows of one global batch: the sums and the count are
    all-reduced over it (differentiably), so the loss is the global
    batch's on every rank."""
    ones = torch.ones(d_mri_logits.shape[0], dtype=torch.long,
                      device=d_mri_logits.device)
    mri = cross_entropy(d_mri_logits, ones, reduce=False)
    pet = cross_entropy(d_pet_logits, torch.zeros_like(ones), reduce=False)
    if mask is None:
        mask = torch.ones_like(mri)
    mri_n, pet_n, n = psum(torch.stack([(mri * mask).sum(),
                                        (pet * mask).sum(), mask.sum()]),
                           group)
    return (mri_n / n + pet_n / n) / 2.0


def supcon_loss(features, labels=None, mask=None, temperature: float = 0.07,
                contrast_mode: str = "all", base_temperature: float = 0.07):
    """Supervised contrastive loss (Khosla et al. 2020) over (B, n_views,
    D) embeddings; with labels and mask both None it is SimCLR's."""
    if features.dim() < 3:
        raise ValueError("features must be [bsz, n_views, ...]")
    if features.dim() > 3:
        features = features.reshape(features.shape[0], features.shape[1], -1)
    b, n_views = features.shape[0], features.shape[1]
    dev = features.device
    if labels is not None and mask is not None:
        raise ValueError("cannot define both labels and mask")
    if labels is None and mask is None:
        mask = torch.eye(b, device=dev)
    elif labels is not None:
        labels = labels.reshape(-1, 1)
        mask = (labels == labels.T).float()
    else:
        mask = mask.float()

    contrast = torch.cat(torch.unbind(features, dim=1), dim=0)  # (B*V, D)
    if contrast_mode == "one":
        anchor, anchor_count = features[:, 0], 1
    elif contrast_mode == "all":
        anchor, anchor_count = contrast, n_views
    else:
        raise ValueError(f"unknown mode {contrast_mode}")

    logits = (anchor @ contrast.T) / temperature
    logits = logits - logits.max(dim=1, keepdim=True).values.detach()
    mask = mask.repeat(anchor_count, n_views)
    self_mask = 1.0 - torch.eye(b * anchor_count, b * n_views, device=dev)
    mask = mask * self_mask
    exp_logits = torch.exp(logits) * self_mask
    log_prob = logits - torch.log(exp_logits.sum(dim=1, keepdim=True))
    mean_log_prob_pos = ((mask * log_prob).sum(dim=1)
                         / mask.sum(dim=1).clamp_min(1e-12))
    loss = -(temperature / base_temperature) * mean_log_prob_pos
    return loss.reshape(anchor_count, b).mean()


def fa_loss(feature_map1, feature_map2):
    """Feature-affinity loss: the mean absolute difference of the token
    Gram matrices of two channels-last (B, X, Y, Z, C) maps."""

    def gram(fm):
        tokens = fm.reshape(fm.shape[0], -1, fm.shape[-1])  # (B, N, C)
        return tokens @ tokens.transpose(1, 2)

    return (gram(feature_map1) - gram(feature_map2)).abs().mean()
