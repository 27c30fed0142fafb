"""Optimizer factory: torch equivalents of the JAX package's optax chains.

Port of transmf_ad_tpu/train/optim.py. Reference schedules (reference:
utils/utils.py:29-41): SGD(lr, wd) + MultiStepLR milestones [10, 26] gamma
0.1; Adam(lr, wd) + MultiStepLR [25, 36] gamma 0.1. The milestones are in
epochs; the scheduler counts train steps (milestones x steps_per_epoch) and
is stepped once per train step, as the JAX package's optax schedule is.
Weight decay is torch's L2 term, added to the gradient before the moments,
which is what `optax.add_decayed_weights` chained before adam does.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

MILESTONES = {"SGD": (10, 26), "Adam": (25, 36), "Mnet": (6, 21)}


def multistep_schedule(lr: float, milestones: Sequence[int],
                       steps_per_epoch: int, gamma: float = 0.1):
    """step -> lr * gamma^(number of milestone steps <= step)."""
    bounds = sorted(int(m) * steps_per_epoch for m in milestones)
    return lambda step: lr * gamma ** sum(step >= b for b in bounds)


def build_optimizer(params, name: str = "Adam", lr: float = 1e-4,
                    weight_decay: float = 0.0, steps_per_epoch: int = 1,
                    milestones: Optional[Sequence[int]] = None,
                    gamma: float = 0.1, momentum: float = 0.0):
    """(optimizer, scheduler) for `params`. name: 'Adam' | 'SGD'.

    milestones=None takes the reference defaults for the optimizer; () gives
    a constant learning rate."""
    if milestones is None:
        milestones = MILESTONES[name]
    if name == "Adam":
        opt = torch.optim.Adam(params, lr=lr, weight_decay=weight_decay)
    elif name == "SGD":
        opt = torch.optim.SGD(params, lr=lr, momentum=momentum,
                              weight_decay=weight_decay)
    else:
        raise ValueError(f"unknown optimizer {name!r}")
    sched = torch.optim.lr_scheduler.MultiStepLR(
        opt, [int(m) * steps_per_epoch for m in milestones], gamma)
    return opt, sched
