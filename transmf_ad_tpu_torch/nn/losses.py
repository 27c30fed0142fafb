"""Losses: the cross-entropy the training drivers use.

Port of `cross_entropy` from transmf_ad_tpu/nn/losses.py (torch
CrossEntropyLoss semantics, float32). The SupCon and feature-affinity
library losses are still to port (ROADMAP.md Queue 1 item 6).
"""

from __future__ import annotations

import torch


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
