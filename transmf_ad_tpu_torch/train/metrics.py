"""Metric accumulators: accuracy, confusion matrix, ROC-AUC, averages.

Port of transmf_ad_tpu/train/metrics.py. The reference wires pytorch-ignite
metrics per engine (reference: kfold_train_adversarial.py:177-187) and
derives sen/spe/f1 from the 2x2 confusion matrix (reference:
utils/utils.py:44-51). Here:

 - `MetricState` holds float32 tensors on the eval step's device, additive
   accumulators updated by the step with the JAX package's arithmetic;
 - exact ROC-AUC (Mann-Whitney with tie correction, sklearn-equivalent) is
   computed in numpy from collected scores at epoch end;
 - `streaming_auc_*` is a fixed-bucket alternative on the device, accurate
   to 1/n_bins.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch


@dataclasses.dataclass
class MetricState:
    correct: torch.Tensor  # ()
    total: torch.Tensor  # ()
    loss_sum: torch.Tensor  # () masked sum of per-sample losses
    batches: torch.Tensor  # ()
    confusion: torch.Tensor  # (2, 2) [true, pred]

    @classmethod
    def zero(cls, device="cpu") -> "MetricState":
        def z(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=device)
        return cls(correct=z(), total=z(), loss_sum=z(), batches=z(),
                   confusion=z(2, 2))

    def update(self, logits, labels, loss, mask=None) -> "MetricState":
        """Accumulate one batch; returns a new state. `mask` (B,) zeroes
        padded samples, so a ragged final batch padded to a fixed size does
        not bias the metrics. `loss` is a per-sample vector (its masked sum
        accumulates, so the final loss is the per-sample mean) or a
        batch-mean scalar (weighted by the valid count)."""
        device = logits.device
        labels = torch.as_tensor(labels, device=device).long()
        if mask is None:
            mask = torch.ones(labels.shape[0], dtype=torch.float32,
                              device=device)
        mask = torch.as_tensor(mask, device=device).float()
        pred = logits.argmax(dim=-1)  # the first maximum, as jnp.argmax
        correct = ((pred == labels).float() * mask).sum()
        eye = torch.eye(2, device=device)
        onehot_t = eye[labels] * mask[:, None]  # (B, 2)
        onehot_p = eye[pred]
        conf = torch.einsum("bi,bj->ij", onehot_t, onehot_p)
        loss = torch.as_tensor(loss, device=device).float()
        n_valid = mask.sum()
        loss_sum = (loss * mask).sum() if loss.ndim else loss * n_valid
        return MetricState(
            correct=self.correct + correct,
            total=self.total + n_valid,
            loss_sum=self.loss_sum + loss_sum,
            batches=self.batches + 1,
            confusion=self.confusion + conf,
        )

    def add(self, other: "MetricState") -> "MetricState":
        """Field-by-field sum with another state (a batch's delta)."""
        return MetricState(**{
            f.name: getattr(self, f.name) + getattr(other, f.name)
            for f in dataclasses.fields(self)})


def confusion_metrics(c) -> Dict[str, float]:
    """sen/spe/f1/precision/recall from a 2x2 [true, pred] confusion matrix
    (reference: utils/utils.py:44-51: TP=c[1,1], FN=c[1,0], FP=c[0,1])."""
    c = np.asarray(c.cpu() if isinstance(c, torch.Tensor) else c)
    tp, fn, fp, tn = c[1, 1], c[1, 0], c[0, 1], c[0, 0]
    precision = tp / (tp + fp) if (tp + fp) else float("nan")
    recall = tp / (tp + fn) if (tp + fn) else float("nan")
    f1 = (
        2 * precision * recall / (precision + recall)
        if precision and recall and np.isfinite(precision)
        and np.isfinite(recall) and (precision + recall) > 0
        else float("nan")
    )
    sen = recall
    spe = tn / (fp + tn) if (fp + tn) else float("nan")
    return {"sen": float(sen), "spe": float(spe), "f1": float(f1),
            "precision": float(precision), "recall": float(recall)}


def roc_auc(scores, labels) -> float:
    """Exact ROC-AUC via the rank statistic, with midrank tie handling
    (equivalent to sklearn.metrics.roc_auc_score for binary labels)."""
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels)
    pos = labels == 1
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty(len(scores), np.float64)
    sorted_scores = scores[order]
    i = 0
    r = 1.0
    while i < len(scores):
        j = i
        while j + 1 < len(scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks[order[i: j + 1]] = (r + r + (j - i)) / 2.0  # midrank
        r += j - i + 1
        i = j + 1
    auc = (ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg)
    return float(auc)


def streaming_auc_init(n_bins: int = 512, device="cpu"):
    """Bucketed AUC state on `device`: per-bin positive/negative counts."""
    return {"pos": torch.zeros(n_bins, device=device),
            "neg": torch.zeros(n_bins, device=device)}


def streaming_auc_update(state, probs, labels):
    """probs: (B,) positive-class probabilities in [0, 1]."""
    n_bins = state["pos"].shape[0]
    device = state["pos"].device
    probs = torch.as_tensor(probs, device=device)
    labels = torch.as_tensor(labels, device=device)
    idx = torch.clamp((probs * n_bins).to(torch.int32), 0, n_bins - 1)
    onehot = torch.eye(n_bins, device=device)[idx.long()]  # (B, n_bins)
    is_pos = (labels == 1).float()
    return {
        "pos": state["pos"] + is_pos @ onehot,
        "neg": state["neg"] + (1.0 - is_pos) @ onehot,
    }


def streaming_auc_result(state) -> float:
    """AUC = P(score_pos > score_neg) + 0.5 P(equal), binned."""
    pos = np.asarray(state["pos"].cpu(), np.float64)
    neg = np.asarray(state["neg"].cpu(), np.float64)
    n_pos, n_neg = pos.sum(), neg.sum()
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    neg_below = np.cumsum(neg) - neg  # negatives strictly below each bin
    wins = (pos * neg_below).sum() + 0.5 * (pos * neg).sum()
    return float(wins / (n_pos * n_neg))
