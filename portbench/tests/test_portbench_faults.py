"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card is skipped and the rest of a run is driven on
the CPU at a tiny size, against each cell's own limits."""

from __future__ import annotations

import pytest
import torch

import transmf_ad_tpu_torch.train as train
from portbench import calibrate
from portbench.tests import tiny



def _planted_step(monkeypatch, fault):
    make = train.make_train_step

    def broken_make(*args, **kw):
        step = make(*args, **kw)

        def broken(state, batch):
            if fault == "unchanged":
                # the forward and loss run, the optimizer step does not
                real = state.optimizer.step
                state.optimizer.step = lambda *a, **k: None
                try:
                    return step(state, batch)
                finally:
                    state.optimizer.step = real
            if fault == "half_batch":
                # every row goes forward; the loss and its gradient are
                # the mean over the first half of the rows alone
                b = batch["label"].shape[0]
                mask = (torch.arange(b, device=batch["label"].device)
                        < b // 2).float()
                return step(state, dict(batch, mask=mask))
            if fault == "answer_altered":
                hook = state.model.register_forward_hook(
                    calibrate.swap_first_answer)
                try:
                    return step(state, batch)
                finally:
                    hook.remove()
            # gradient_scaled: the backward's gradients half again too
            # large, as a backward kernel off by a factor would leave
            # them; Adam's step is blind to the scale
            real = state.optimizer.step

            def scaled(*a, **k):
                for p in state.model.parameters():
                    if p.grad is not None:
                        p.grad.mul_(1.5)
                return real(*a, **k)
            state.optimizer.step = scaled
            try:
                return step(state, batch)
            finally:
                state.optimizer.step = real
        return broken

    monkeypatch.setattr(train, "make_train_step", broken_make)


@pytest.mark.parametrize("cell", tiny.CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half_batch",
                                   "answer_altered", "gradient_scaled"])
def test_train_fault_is_not_correct(monkeypatch, cell, fault):
    _planted_step(monkeypatch, fault)
    res = tiny.run(cell)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_sound_run_is_correct(cell):
    assert tiny.run(cell)["correct"]
