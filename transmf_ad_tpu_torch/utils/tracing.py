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
spans their cost. The range's clock is read inside its `__enter__` and
`__exit__`, and the span's next to them (after each), so anything that runs
between the two reads moves one against the other:
- the first range a thread opens in a profiler session sets up the
  profiler's state for that thread after its clock read (11-73 us on an
  8-core x86 host beside six CPU-bound processes, 0.33 ms in a full test
  run); in a process's first session the range's op is also looked up and
  dispatched for the first time (1.1-1.3 ms). A span that finds the profiler
  on for the first time since it last found it off (or since `enable`)
  spends both on a range of its own, "tracing warm-up", first;
- a pass of Python's cyclic garbage collector, which the allocations in
  `record_function` can set off (0.3-1.7 ms), and which the two reads hold
  off.
Measured there (`torch.profiler` on the CPU, 300 sessions of 10 spans):
with both measures a session's first span starts within 22 us of its
range and the others within 44 us; without the warm-up the first within
73 us.
"""

from __future__ import annotations

import gc
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
            if not getattr(_local, "in_session", False):
                with torch.profiler.record_function("tracing warm-up"):
                    pass
                _local.in_session = True
            label = self.name if self.n is None else f"{self.name} {self.n}"
            self.range = torch.profiler.record_function(label)
            collect = _hold_collection()
            try:
                self.range.__enter__()
                self.start = time.time_ns()
            finally:
                if collect:
                    gc.enable()
        else:
            _local.in_session = False
            self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        if self.range is None:
            end = time.time_ns()
        else:
            collect = _hold_collection()
            try:
                self.range.__exit__(*exc)
                end = time.time_ns()
            finally:
                if collect:
                    gc.enable()
        _local.stack.pop()
        _spans.append(Span(self.name, self.n, self.start, end, self.id,
                           self.parent, threading.get_ident(), self.step))
        return False


def _hold_collection() -> bool:
    """Hold off Python's cyclic garbage collector between a range's clock
    read and the span's; returns whether it was on (the caller turns it back
    on)."""
    collect = gc.isenabled()
    gc.disable()
    return collect


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
    _local.in_session = False  # a profiler session may start after this
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
