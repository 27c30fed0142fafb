"""Per-iteration training progress bar (pytorch-ignite ProgressBar role).

Port of transmf_ad_tpu/utils/progress.py; it prints the same text. The
reference attaches `ignite.contrib.handlers.ProgressBar(persist=True)` to
both its train and eval engines (reference:
kfold_train_adversarial.py:139,164) so long epochs are never silent. This is
the equivalent for `train.engine.Engine`, with one rule: it NEVER reads step
outputs. Fetching a loss value every iteration (`.item()`, `.cpu()`) would
synchronize the host with the card and stall the queue of launches. It
reports iteration progress and dispatch rate only; per-epoch metrics stay in
the epoch-end handlers, where one synchronization serves the whole epoch.

On a TTY it redraws one `\r` bar line; on a non-TTY stream (log files,
CI) it prints a plain line every `log_every` iterations instead of
flooding the log.
"""

from __future__ import annotations

import sys
import time
from typing import Optional

from ..train.engine import Events


def _fmt_t(seconds: float) -> str:
    seconds = max(0, int(seconds))
    m, s = divmod(seconds, 60)
    h, m = divmod(m, 60)
    return f"{h:d}:{m:02d}:{s:02d}" if h else f"{m:02d}:{s:02d}"


class ProgressBar:
    """Attach to an Engine: per-iteration progress for each epoch.

    persist=True (the reference's setting) keeps each epoch's final bar
    line in the terminal; False erases it when the epoch completes.
    """

    def __init__(self, persist: bool = True, file=None, width: int = 24,
                 min_interval: float = 0.1, log_every: int = 10):
        self.persist = persist
        self.file = file if file is not None else sys.stderr
        self.width = width
        self.min_interval = min_interval
        self.log_every = log_every
        self._total: Optional[int] = None
        self._count = 0
        self._t0 = 0.0
        self._last_draw = 0.0

    # -- engine wiring ------------------------------------------------

    def attach(self, engine, total: Optional[int] = None):
        self._total = total
        engine.add_event_handler(Events.EPOCH_STARTED, self._on_epoch_start)
        engine.add_event_handler(Events.ITERATION_COMPLETED, self._on_iter)
        engine.add_event_handler(Events.EPOCH_COMPLETED, self._on_epoch_end)
        return self

    # -- handlers -----------------------------------------------------

    def _on_epoch_start(self, engine):
        self._count = 0
        self._t0 = time.perf_counter()
        self._last_draw = 0.0

    def _on_iter(self, engine):
        self._count += 1
        now = time.perf_counter()
        if self._isatty():
            if now - self._last_draw >= self.min_interval:
                self._draw(engine, now)
        elif self._count % self.log_every == 0 or self._count == self._total:
            self._line(engine, now)

    def _on_epoch_end(self, engine):
        if not self._isatty():
            return
        self._draw(engine, time.perf_counter())
        if self.persist:
            self.file.write("\n")
        else:
            self.file.write("\r" + " " * 79 + "\r")
        self.file.flush()

    # -- rendering ----------------------------------------------------

    def _isatty(self) -> bool:
        return bool(getattr(self.file, "isatty", lambda: False)())

    def _prefix(self, engine) -> str:
        return f"Epoch [{engine.state.epoch}/{engine.state.max_epochs}]"

    def _rate(self, now: float) -> str:
        dt = now - self._t0
        return f"{self._count / dt:.2f} it/s" if dt > 0 else ""

    def _draw(self, engine, now):
        self._last_draw = now
        n, total = self._count, self._total
        if total:
            frac = min(1.0, n / total)
            filled = int(frac * self.width)
            bar = "█" * filled + "░" * (self.width - filled)
            eta = ((now - self._t0) / n * (total - n)) if n else 0.0
            msg = (f"\r{self._prefix(engine)} [{n}/{total}] {frac:4.0%}"
                   f"|{bar}| {self._rate(now)}"
                   f" [{_fmt_t(now - self._t0)}<{_fmt_t(eta)}]")
        else:
            msg = (f"\r{self._prefix(engine)} [{n}/?] {self._rate(now)}"
                   f" [{_fmt_t(now - self._t0)}]")
        self.file.write(msg[:160])
        self.file.flush()

    def _line(self, engine, now):
        total = f"/{self._total}" if self._total else ""
        self.file.write(f"{self._prefix(engine)} iteration {self._count}"
                        f"{total} ({self._rate(now)})\n")
        self.file.flush()


def iter_progress(iterable, total: Optional[int] = None,
                  label: str = "Eval", file=None, enabled: bool = True):
    """Wrap a plain iterable with the same TTY progress line (the
    reference attaches ProgressBar to its evaluator engine too). Non-TTY
    streams stay silent — eval epochs are short and already logged."""
    if not enabled:
        yield from iterable
        return
    f = file if file is not None else sys.stderr
    tty = bool(getattr(f, "isatty", lambda: False)())
    if not tty:
        yield from iterable
        return
    t0 = time.perf_counter()
    n = 0
    for item in iterable:
        n += 1
        tot = f"/{total}" if total else ""
        f.write(f"\r{label}: [{n}{tot}] "
                f"({n / max(time.perf_counter() - t0, 1e-9):.2f} it/s)")
        f.flush()
        yield item
    f.write("\r" + " " * 79 + "\r")
    f.flush()
