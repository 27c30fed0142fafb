"""The traced stretch of a `--trace 1` run: `torch.profiler` (CUPTI) over a
few steps or requests after the measured window, reduced to what the
per-layer metrics read.

- busy time: the union of the device intervals (kernels, copies, sets),
  over the stretch's host-clock length (`profile_train.py`'s `busy_ms`);
- kernels by kind: hand-written (the program's `transmf` namespace),
  cuDNN / cuBLAS, or PyTorch's own (`profile_train.py`'s `kernel_kind`);
- each `transmf::<op>` call's kernels: a kernel is tied through its
  launch's correlation id to the runtime call, and that to the outermost
  op of its thread whose interval holds it; the calls' least time
  (`counts/kernels.py`) and device time, in all and by op (an op with no
  count is left out of both and named on standard error);
- host-to-device copies;
- the breakdown: the device operations that took most time, and the
  device's idle time by the innermost host op running as each gap opened.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import re
import sys
import time

import torch

KINDS = ("hand-written", "cuDNN / cuBLAS", "PyTorch")


def kernel_kind(name: str) -> str:
    low = name.lower()
    if "transmf" in low:
        return "hand-written"
    if any(k in low for k in ("cudnn", "xmma", "cutlass", "gemm", "sm90_",
                              "nhwc", "convolve", "winograd", "fft",
                              "cublas")):
        return "cuDNN / cuBLAS"
    return "PyTorch"


def _is_device(ev) -> bool:
    return ev.device_type() == torch.autograd.DeviceType.CUDA


def _short(name: str) -> str:
    """A kernel's name without its template and argument lists."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"\(.*", "", name)
    depth, out = 0, []
    for ch in name:
        depth += ch == "<"
        if depth == 0:
            out.append(ch)
        depth -= ch == ">" and depth > 0
    name = "".join(out).replace("void ", "").strip()
    return name[-120:]


@dataclasses.dataclass
class Trace:
    """What a traced stretch gives the metrics."""
    window_s: float  # host clock over the stretch, ending in a sync
    units: int  # steps or requests in the stretch
    busy_s: float = 0.0
    kernels: int = 0  # device kernels launched
    by_kind_s: dict = dataclasses.field(default_factory=dict)
    op_least_s: float = 0.0  # sum over transmf:: calls of the least time
    op_device_s: float = 0.0  # sum of the device time of their kernels
    # the same by op: {op: {"least_s", "device_s"}}
    by_op: dict = dataclasses.field(default_factory=dict)
    # ops with no count, left out of the sums: {op: {"calls", "device_s"}}
    uncounted: dict = dataclasses.field(default_factory=dict)
    device_ops: list = dataclasses.field(default_factory=list)
    idle_gaps: list = dataclasses.field(default_factory=list)


def _union(intervals):
    busy, cur = 0, None
    gaps = []
    for s, e in sorted(intervals):
        if cur is None:
            cur = [s, e]
        elif s > cur[1]:
            busy += cur[1] - cur[0]
            gaps.append((cur[1], s))
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur:
        busy += cur[1] - cur[0]
    return busy, gaps


def _profiled(run_units, units, activities, shapes: bool):
    """(kineto events, host-clock seconds) of `units` steps or requests."""
    from torch.profiler import profile

    sync = torch.cuda.synchronize if torch.cuda.is_available() else (
        lambda: None)
    sync()
    with profile(activities=activities, record_shapes=shapes) as prof:
        t0 = time.perf_counter()
        run_units(units)
        sync()
        t1 = time.perf_counter()
    return prof.profiler.kineto_results.events(), t1 - t0


def add_op_calls(out: Trace, calls, log=sys.stderr) -> None:
    """Add `calls`, (op, shapes, dtypes, device seconds) of each
    `transmf::<op>` call, to `out`'s sums of least and device time, in all
    and by op. A call of an op with no count goes to `out.uncounted`
    instead, and each such op is named on `log` with its calls and device
    ms."""
    from .counts import kernels as counts

    for name, shapes, dtypes, device_s in calls:
        least = counts.least_time_s(name, shapes, dtypes)
        if least is None:
            u = out.uncounted.setdefault(name, {"calls": 0, "device_s": 0.0})
            u["calls"] += 1
            u["device_s"] += device_s
            continue
        out.op_least_s += least[0]
        out.op_device_s += device_s
        b = out.by_op.setdefault(name, {"least_s": 0.0, "device_s": 0.0})
        b["least_s"] += least[0]
        b["device_s"] += device_s
    for name, u in out.uncounted.items():
        print(f"uncounted transmf::{name} {u['calls']} "
              f"{1e3 * u['device_s']!r}", file=log)


def trace(run_units, units: int, log=sys.stderr) -> Trace:
    """Profile `run_units(units)` twice (each stretch runs that many steps
    or requests and ends in `torch.cuda.synchronize()`): once with the
    device alone traced, which costs the host next to nothing, for the busy
    and idle time, the launches and the device operations; once with the
    host's ops and their shapes too, for the kernel ops' least time and the
    host op behind each idle gap (that stretch runs slower: the profiler
    records every host op). Ops with no count are named on `log`."""
    from torch.profiler import ProfilerActivity

    cuda = [ProfilerActivity.CUDA] if torch.cuda.is_available() else []
    events, window_s = _profiled(run_units, units,
                                 cuda or [ProfilerActivity.CPU], False)
    out = Trace(window_s=window_s, units=units)
    device = [e for e in events if _is_device(e)]
    spans = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in device
             if e.duration_ns() > 0]
    busy_ns, gaps = _union(spans)
    out.busy_s = busy_ns * 1e-9

    per_name = collections.Counter()
    by_kind = collections.Counter()
    for e in device:
        name = e.name()
        dur = e.duration_ns() * 1e-9
        low = name.lower()
        if "memcpy" in low or "memset" in low:
            per_name[_short(name)] += dur
            continue
        out.kernels += 1
        by_kind[kernel_kind(name)] += dur
        per_name[_short(name)] += dur
    out.by_kind_s = {k: by_kind.get(k, 0.0) for k in KINDS}
    out.device_ops = [[n, s] for n, s in per_name.most_common(10)]

    events, _ = _profiled(run_units, units,
                          [ProfilerActivity.CPU] + cuda, True)
    device = [e for e in events if _is_device(e)]
    host = [e for e in events if not _is_device(e)]
    spans = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in device
             if e.duration_ns() > 0]
    _, gaps = _union(spans)

    # the outermost transmf:: op of each thread, as sorted intervals
    ops = collections.defaultdict(list)
    for e in host:
        if e.name().startswith("transmf::"):
            ops[e.start_thread_id()].append(e)
    outer = {}
    for tid, evs in ops.items():
        evs.sort(key=lambda e: (e.start_ns(), -e.duration_ns()))
        keep, end = [], -1
        for e in evs:
            if e.start_ns() >= end:
                keep.append(e)
                end = e.start_ns() + e.duration_ns()
        outer[tid] = keep
    starts = {tid: [e.start_ns() for e in evs] for tid, evs in outer.items()}
    # a kernel's linked id names the innermost host op around its launch
    # (or, in older profilers, the runtime call that launched it)
    linked = {e.correlation_id(): e for e in host
              if e.linked_correlation_id() > 0}
    linked.update({e.correlation_id(): e for e in host
                   if e.linked_correlation_id() == 0})
    device_s = collections.Counter()
    for e in device:
        at = linked.get(e.linked_correlation_id())
        if at is None or at.start_thread_id() not in outer:
            continue
        tid = at.start_thread_id()
        i = bisect.bisect_right(starts[tid], at.start_ns()) - 1
        if i < 0:
            continue
        op = outer[tid][i]
        if at.start_ns() <= op.start_ns() + op.duration_ns():
            device_s[id(op)] += e.duration_ns() * 1e-9
    add_op_calls(out, [(op.name().split("::", 1)[1].split(".")[0],
                        op.shapes(), op.dtypes(), device_s[id(op)])
                       for evs in outer.values() for op in evs
                       if id(op) in device_s], log)

    # idle gaps by the innermost host op running when each gap opens, on
    # any thread (the backward runs on autograd's thread)
    ops_by_thread = collections.defaultdict(list)
    for e in host:
        if not e.name().startswith(("cuda", "cu")):
            ops_by_thread[e.start_thread_id()].append(e)
    for evs in ops_by_thread.values():
        evs.sort(key=lambda e: e.start_ns())
    tstarts = {t: [e.start_ns() for e in evs]
               for t, evs in ops_by_thread.items()}
    by_host = collections.Counter()
    for g0, g1 in gaps:
        best = None
        for t, evs in ops_by_thread.items():
            i = bisect.bisect_right(tstarts[t], g0) - 1
            for e in evs[max(i - 64, 0):i + 1][::-1]:  # innermost first
                if e.start_ns() + e.duration_ns() >= g0:
                    if best is None or e.start_ns() > best.start_ns():
                        best = e
                    break
        label = "(no host op)" if best is None else best.name()
        by_host[label] += (g1 - g0) * 1e-9
    out.idle_gaps = [[n, s] for n, s in by_host.most_common(10)]
    return out
