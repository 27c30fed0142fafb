"""Minimal event-driven training engine (the pytorch-ignite role).

A copy of transmf_ad_tpu/train/engine.py. The reference wires ignite
`Engine(step)` loops with event handlers for LR scheduling, epoch logging,
validation, checkpointing and final test (reference:
kfold_train_adversarial.py:138-252). An `Engine` runs a step function over
a loader for N epochs and fires handlers on `Events`; the wait for each
batch is a "feed" span of `utils/tracing.py`.
"""

from __future__ import annotations

import enum
import time
from types import SimpleNamespace
from typing import Callable, Dict, List

from ..utils import tracing

_END = object()


class Events(enum.Enum):
    STARTED = "started"
    EPOCH_STARTED = "epoch_started"
    ITERATION_COMPLETED = "iteration_completed"
    EPOCH_COMPLETED = "epoch_completed"
    COMPLETED = "completed"


class Engine:
    """Runs `step_fn(engine, batch)` over a loader; fires event handlers.

    `engine.state` carries: epoch, max_epochs, iteration (global), output
    (last step output), metrics (dict filled by handlers/metric hooks), and
    arbitrary attributes handlers attach (like ignite's State).
    """

    def __init__(self, step_fn: Callable):
        self.step_fn = step_fn
        self.handlers: Dict[Events, List] = {e: [] for e in Events}
        self.state = SimpleNamespace(
            epoch=0, max_epochs=0, iteration=0, output=None, metrics={},
            epoch_time=0.0,
        )
        self._terminate = False

    def add_event_handler(self, event: Events, handler: Callable, *args, **kw):
        self.handlers[event].append((handler, args, kw))
        return handler

    def remove_event_handler(self, handler: Callable, event: Events):
        self.handlers[event] = [
            h for h in self.handlers[event] if h[0] is not handler
        ]

    def on(self, event: Events):
        def decorator(fn):
            self.add_event_handler(event, fn)
            return fn

        return decorator

    def terminate(self):
        self._terminate = True

    def _fire(self, event: Events):
        for handler, args, kw in list(self.handlers[event]):
            handler(self, *args, **kw)

    def run(self, loader, max_epochs: int = 1, start_epoch: int = 0):
        self.state.max_epochs = max_epochs
        self.state.epoch = start_epoch
        self._terminate = False
        self._fire(Events.STARTED)
        while self.state.epoch < max_epochs and not self._terminate:
            self.state.epoch += 1
            t0 = time.perf_counter()
            self.state.epoch_t0 = t0  # for handlers that time past a sync
            self._fire(Events.EPOCH_STARTED)
            batches = iter(loader)
            while True:
                with tracing.span("feed"):  # the wait for the next batch
                    batch = next(batches, _END)
                if batch is _END:
                    break
                self.state.iteration += 1
                self.state.output = self.step_fn(self, batch)
                self._fire(Events.ITERATION_COMPLETED)
                if self._terminate:
                    break
            self.state.epoch_time = time.perf_counter() - t0
            self._fire(Events.EPOCH_COMPLETED)
        self._fire(Events.COMPLETED)
        return self.state
