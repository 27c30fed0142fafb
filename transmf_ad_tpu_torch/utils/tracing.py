"""Spans and counters of the port's train path, off by default.

    from transmf_ad_tpu_torch.utils import tracing

    tracing.enable()
    step(state, batch)            # opens "step", "prep", "augment", ...
    spans, counters = tracing.drain()
    tracing.disable()

`span(name, n)` is a context manager around a stretch of host work: it
records the name, the start and end, the span it opened inside (on the
same thread), the thread, and the step id that every span inside one
"step" span shares (a new id for each "step"). `n`, where given, is a
number the span carries (a step's or an iteration's count). `count(name,
k)` adds `k` to a counter. Spans and counters stay in memory until
`drain()` hands them to its caller, which writes them out if it wants
them.

Off, `span` is one check of a module flag that returns the shared no-op
context `NOOP`, and `count` is the same check: neither builds a string nor
allocates. The callers that turn tracing on are the benchmark and the
Trainer's profiler window (`TrainerConfig.profile_dir`).

Spans are stamped with `time.time_ns()`, the Unix-epoch clock on which
`torch.profiler`'s events carry their `start_ns()`, so a span and the
device work launched inside it can be laid on one time line. While a
profiler is on and `enable(ranges=True)` (the default), each span also
opens a `torch.profiler.record_function` range named after it ("iteration
3", "step 12", "encoder conv2.0"), so a Chrome trace shows the spans nested
around the ops and kernels they issued. A profiler that records the device
alone records no such range: `enable(ranges=False)` then spares the
spans their cost.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import NamedTuple, Optional

import torch


class Span(NamedTuple):
    name: str
    n: Optional[int]  # the step's or iteration's number, where given
    start_ns: int  # time.time_ns(), the profiler's clock
    end_ns: int
    id: int
    parent: Optional[int]  # the id of the span it opened inside
    thread: int
    step: Optional[int]  # the id shared by the spans of one "step"


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NOOP = _Noop()
ON = False  # read by the instrumented call sites; set by enable / disable
_ranges = True
_spans: list = []
_counters: dict = {}
_lock = threading.Lock()
_local = threading.local()
_ids = itertools.count(1)
_step_ids = itertools.count(1)


class _Open:
    __slots__ = ("name", "n", "start", "id", "parent", "step", "range")

    def __init__(self, name, n):
        self.name, self.n = name, n

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        up = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = None if up is None else up.id
        self.step = (next(_step_ids) if self.name == "step"
                     else None if up is None else up.step)
        stack.append(self)
        self.range = None
        if _ranges and torch.autograd.profiler._is_profiler_enabled:
            label = self.name if self.n is None else f"{self.name} {self.n}"
            self.range = torch.profiler.record_function(label)
            self.range.__enter__()
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        _local.stack.pop()
        _spans.append(Span(self.name, self.n, self.start, end, self.id,
                           self.parent, threading.get_ident(), self.step))
        return False


def span(name: str, n: Optional[int] = None):
    """A context manager recording `name` while tracing is on; `NOOP`
    otherwise."""
    if not ON:
        return NOOP
    return _Open(name, n)


def count(name: str, k: int = 1) -> None:
    """Add `k` to the counter `name` while tracing is on."""
    if not ON:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + k


def enable(ranges: bool = True) -> None:
    """Start recording. ranges: open a record_function range with each
    span while a profiler is on."""
    global ON, _ranges
    _ranges = ranges
    ON = True


def disable() -> None:
    """Stop recording; what was recorded stays until `drain()`."""
    global ON
    ON = False


def drain():
    """(spans in the order they ended, {counter: value}) recorded since the
    last drain, which are then forgotten."""
    global _spans, _counters
    with _lock:
        spans, counters = _spans, _counters
        _spans, _counters = [], {}
    return spans, counters
