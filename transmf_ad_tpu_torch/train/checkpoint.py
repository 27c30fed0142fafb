"""Checkpointing: best-by-metric retention + full-state resume.

Port of transmf_ad_tpu/train/checkpoint.py. The reference keeps n_saved=1
best-by-val-accuracy model files named
`best_label_net_model_<epoch>_accuracy=<v>.pt` and reloads them before the
test pass (reference: kfold_train_adversarial.py:222-233). The port writes
that file as the reference does, with `torch.save`: the model's
`state_dict` under the reference's names, which the JAX package's
`utils/torch_import.py::import_torch_checkpoint` reads back. `latest.pt`
holds the full state for crash-resume (absent upstream): the model, the
optimizer, the scheduler, the step count, the state of the generator that
augmentation and dropout draw from, and the epoch. The JAX package's
`.msgpack` files need flax, which the port does not use.
"""

from __future__ import annotations

import collections
import glob
import os
import re
from typing import Any, Dict, Optional

import torch


class BestCheckpointer:
    """Keep the n_saved best checkpoints by score (greater-or-equal wins,
    like the reference's greater_or_equal=True)."""

    def __init__(self, save_dir: str, prefix: str = "best_label_net_model",
                 score_name: str = "accuracy", n_saved: int = 1):
        self.save_dir = save_dir
        self.prefix = prefix
        self.score_name = score_name
        self.n_saved = n_saved
        self._saved = []  # list of (score, path), best last
        os.makedirs(save_dir, exist_ok=True)

    def maybe_save(self, target: Optional[Dict[str, Any]], score: float,
                   epoch: int, write: bool = True) -> Optional[str]:
        # greater_or_equal retention: skip only when full and strictly worse
        # than the current worst kept score.
        if len(self._saved) >= self.n_saved and score < self._saved[0][0]:
            return None
        path = os.path.join(
            self.save_dir,
            f"{self.prefix}_{epoch}_{self.score_name}={score:.4f}.pt",
        )
        if write:
            torch.save(target, path)
        self._saved.append((score, path))
        self._saved.sort(key=lambda t: t[0])
        while len(self._saved) > self.n_saved:
            _, old = self._saved.pop(0)
            if write and os.path.exists(old):
                os.remove(old)
        return path

    def track(self, score: float, epoch: int) -> Optional[str]:
        """Record the retention decision without touching disk."""
        return self.maybe_save(None, score, epoch, write=False)

    def best_path(self) -> Optional[str]:
        if self._saved:
            return self._saved[-1][1]
        return find_best(self.save_dir, self.prefix, self.score_name)


def find_best(save_dir: str, prefix: str = "best_label_net_model",
              score_name: str = "accuracy") -> Optional[str]:
    """Locate the best checkpoint on disk by the score in its filename."""
    pat = os.path.join(save_dir, f"{prefix}_*_{score_name}=*.pt")
    best, best_score = None, -float("inf")
    for p in glob.glob(pat):
        m = re.search(rf"{score_name}=([0-9.]+)\.pt$", p)
        if m:
            s = float(m.group(1))
            if s >= best_score:
                best, best_score = p, s
    return best


def load(path: str) -> Dict[str, Any]:
    """A model state_dict from a `.pt` / `.pth` file: a bare state_dict, or
    one wrapped under 'net_model' / 'model' / 'state_dict', as the JAX
    package's torch import accepts. A flax `.msgpack` raises."""
    if path.endswith(".msgpack"):
        raise ValueError(
            f"{path}: a flax .msgpack checkpoint of the JAX package; the "
            "port reads torch .pt / .pth files")
    if not path.endswith((".pt", ".pth")):
        raise ValueError(f"{path}: expected a .pt or .pth checkpoint")
    obj = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("net_model", "model", "state_dict"):
        if isinstance(obj.get(key), dict):
            return obj[key]
    return obj


def save_latest(save_dir: str, target: Dict[str, Any]) -> str:
    """Full-state checkpoint for resume, written atomically. The scheduler's
    milestone Counter is stored as a plain dict (`load_latest` restores
    it), so the file loads with `weights_only=True`."""
    os.makedirs(save_dir, exist_ok=True)
    target = dict(target)
    if "scheduler" in target:
        sched = dict(target["scheduler"])
        sched["milestones"] = dict(sched["milestones"])
        target["scheduler"] = sched
    path = os.path.join(save_dir, "latest.pt")
    tmp = path + ".tmp"
    torch.save(target, tmp)
    os.replace(tmp, path)
    return path


def load_latest(save_dir: str) -> Optional[Dict[str, Any]]:
    path = os.path.join(save_dir, "latest.pt")
    if not os.path.exists(path):
        return None
    out = torch.load(path, map_location="cpu", weights_only=True)
    if "scheduler" in out:
        out["scheduler"]["milestones"] = collections.Counter(
            out["scheduler"]["milestones"])
    return out
