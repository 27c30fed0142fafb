"""The program's own spans and counters in a `--trace 1` run
(`transmf_ad_tpu_torch/utils/tracing.py`), read after the profiled
stretches of `profiling.py`, which they leave as they are.

By the time the readers run, the cell's program object has been freed for
the check, so the first reader that asks builds a new one of the cell's
kind (`kinds/<kind>.py`'s `CellRun`, from the fixed seed `SEED`: these
stretches measure time, not values), and runs two stretches of
`mix["trace_units"]` steps each with the program's tracer on:

- (S) no profiler: the host's spans and counters, free of CUPTI's cost;
- (D) a device-only profiler (`ProfilerActivity.CUDA`): the spans and the
  device's kernels, copies and sets on one clock (the spans are stamped
  with `time.time_ns()`, on which the profiler's events carry their
  start). Each device operation is charged to the innermost span open when
  the runtime call that launched it ran, found through the correlation
  id; each idle gap of the device to the span that launched the operation
  which closes it, the span the device was waiting on.

The result is kept on the readers' context as `ctx.spans` (a `Spans`, or
None where the program has no tracer or the stretch saw nothing); the
idle-by-span table of (D) and the counters a step go to standard error.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import sys
import time

from . import harness

SEED = 20  # the stretches' weights and rows


@dataclasses.dataclass
class Spans:
    """What the program's spans give the readers (per step: over the
    stretch's steps)."""
    units: int
    host_issue_ms: float  # (S) in "step" spans, less their "sync" spans
    sync_wait_ms: float  # (S) in "sync" spans
    op_dispatch_us: float | None  # (S) op.*.host_ns over op.*.calls
    wall_ms: float  # (S) the stretch's host clock a step, to a sync
    counters: dict  # (S) a step
    augment_ms: float | None = None  # (D) device ms launched in "augment"
    device: dict | None = None  # (D) the rest of `charge`'s result


def host_numbers(spans, counters, units: int) -> dict:
    """host_issue_ms, sync_wait_ms (per step) and op_dispatch_us from one
    stretch's spans and counters."""
    step = sum(s.end_ns - s.start_ns for s in spans if s.name == "step")
    sync = sum(s.end_ns - s.start_ns for s in spans if s.name == "sync"
               and s.step is not None)
    calls = sum(v for k, v in counters.items()
                if k.startswith("op.") and k.endswith(".calls"))
    host = sum(v for k, v in counters.items()
               if k.startswith("op.") and k.endswith(".host_ns"))
    return {"host_issue_ms": (step - sync) * 1e-6 / units,
            "sync_wait_ms": sync * 1e-6 / units,
            "op_dispatch_us": host * 1e-3 / calls if calls else None}


def innermost(spans):
    """(starts, owners): the time line cut where any span starts or ends;
    owners[i] is the innermost span (the latest started) open from
    starts[i] to starts[i + 1], or None."""
    marks = sorted([(s.start_ns, 1, i) for i, s in enumerate(spans)]
                   + [(s.end_ns, 0, i) for i, s in enumerate(spans)])
    starts, owners, open_ = [], [], []
    for t, is_start, i in marks:
        if is_start:
            open_.append(i)
        else:
            open_.remove(i)
        owner = spans[open_[-1]] if open_ else None
        if starts and starts[-1] == t:
            owners[-1] = owner
        else:
            starts.append(t)
            owners.append(owner)
    return starts, owners


def charge(spans, ops, units: int) -> dict:
    """Charge device operations and idle gaps to spans.

    ops: (launch_ns or None, start_ns, end_ns) of each device operation,
    launch_ns the start of the runtime call that launched it. Returns, per
    step: `by_span_ms` (device ms by the innermost span open at the
    launch), `idle_by_span_ms` (each gap between the device's busy
    intervals charged to the span that launched the operation closing it),
    `busy_ms`, `idle_ms`; and the shares `in_step_pct` (device time
    launched inside a "step" span or one of its descendants),
    `launched_in_span_pct` (device time whose launch lies in any span),
    `found_pct` (device time whose launch was found), `idle_charged_pct`
    and `gaps_over_100us_uncharged` (a count)."""
    starts, owners = innermost(list(spans))

    def owner(t):
        if t is None:
            return None
        i = bisect.bisect_right(starts, t) - 1
        return owners[i] if i >= 0 else None

    ops = sorted(ops, key=lambda o: o[1])
    total = sum(e - s for _, s, e in ops)
    by_span = collections.Counter()
    in_step = in_span = found = 0
    for launch, s, e in ops:
        sp = owner(launch)
        d = e - s
        found += d if launch is not None else 0
        if sp is not None:
            by_span[sp.name] += d
            in_span += d
            in_step += d if sp.step is not None else 0
    idle = collections.Counter()
    busy = idle_total = idle_charged = 0
    uncharged_long = 0
    cur = None
    for launch, s, e in ops:
        if cur is None:
            cur = [s, e]
            continue
        if s > cur[1]:
            gap = s - cur[1]
            idle_total += gap
            sp = owner(launch)
            if sp is None:
                idle["(no span)"] += gap
                uncharged_long += gap > 100_000
            else:
                idle[sp.name] += gap
                idle_charged += gap
            busy += cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        busy += cur[1] - cur[0]

    def pct(x, of):
        return 100.0 * x / of if of else None

    def per_step_ms(c):
        return {k: v * 1e-6 / units for k, v in c.most_common()}

    return {"by_span_ms": per_step_ms(by_span),
            "idle_by_span_ms": per_step_ms(idle),
            "busy_ms": busy * 1e-6 / units,
            "idle_ms": idle_total * 1e-6 / units,
            "in_step_pct": pct(in_step, total),
            "launched_in_span_pct": pct(in_span, total),
            "found_pct": pct(found, total),
            "idle_charged_pct": pct(idle_charged, idle_total),
            "gaps_over_100us_uncharged": uncharged_long}


def device_ops(events) -> list:
    """(launch_ns, start_ns, end_ns) of each device operation in a
    profiler's kineto events; launch_ns is the start of the runtime call
    with the operation's correlation id (None where the trace has none)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device = [e for e in events if e.device_type() == cuda
              and e.duration_ns() > 0]
    runtime = {e.correlation_id(): e for e in events
               if e.device_type() != cuda and e.name().startswith("cu")}
    out = []
    for e in device:
        call = (runtime.get(e.correlation_id())
                or runtime.get(e.linked_correlation_id()))
        out.append((None if call is None else call.start_ns(), e.start_ns(),
                    e.start_ns() + e.duration_ns()))
    return out


def _stretch(tracing, drv, units, profiled: bool):
    """(spans, counters, host seconds, kineto events or None) of `units`
    steps with the tracer on; with `profiled`, under a device-only
    profiler."""
    import torch

    sync = (torch.cuda.synchronize if drv.device.type == "cuda"
            else (lambda: None))
    sync()
    tracing.drain()
    tracing.enable(ranges=False)
    try:
        if profiled:
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                drv.run_units(units)
                sync()
                t1 = time.perf_counter()
            events = prof.profiler.kineto_results.events()
        else:
            t0 = time.perf_counter()
            drv.run_units(units)
            sync()
            t1 = time.perf_counter()
            events = None
    finally:
        tracing.disable()
    spans, counters = tracing.drain()
    return spans, counters, t1 - t0, events


def measure(ctx, log=sys.stderr):
    """Run (S) and (D) for the cell in `ctx`; a `Spans`, or None where the
    program has no tracer (an older program) or no step was traced."""
    try:
        from transmf_ad_tpu_torch.utils import tracing
    except ImportError:
        return None
    import torch

    device = "cuda" if torch.cuda.is_available() else "cpu"
    if device == "cuda":
        torch.cuda.empty_cache()
    units = ctx.mix["trace_units"]
    drv = harness.kind(ctx.mix["kind"]).CellRun(
        ctx.cfg, ctx.mix, harness.subseed(SEED, 0), device, {})
    drv.setup()
    spans, counters, wall_s, _ = _stretch(tracing, drv, units, False)
    if not any(s.name == "step" for s in spans):
        return None
    host = host_numbers(spans, counters, units)
    out = Spans(units=units, wall_ms=1e3 * wall_s / units,
                counters={k: v / units for k, v in sorted(counters.items())},
                **host)
    if device == "cuda":
        spans, _, d_wall_s, events = _stretch(tracing, drv, units, True)
        out.device = charge(spans, device_ops(events), units)
        out.device["host_issue_ms"] = host_numbers(
            spans, {}, units)["host_issue_ms"]
        out.device["wall_ms"] = 1e3 * d_wall_s / units
        out.augment_ms = out.device["by_span_ms"].get("augment", 0.0)
    del drv
    report(out, log)
    return out


def report(s: Spans, log) -> None:
    """The stretches' numbers on standard error."""
    print(f"spans (S, {s.units} steps): step wall {s.wall_ms:.3f} ms, "
          f"host issue {s.host_issue_ms:.3f} ms, sync wait "
          f"{s.sync_wait_ms:.3f} ms, op dispatch {s.op_dispatch_us} us",
          file=log)
    print("spans (S): counters a step "
          + ", ".join(f"{k} {v:g}" for k, v in s.counters.items()), file=log)
    d = s.device
    if d is None:
        return
    print(f"spans (D): step wall {d['wall_ms']:.3f} ms, host issue "
          f"{d['host_issue_ms']:.3f} ms, device busy {d['busy_ms']:.3f} ms, "
          f"idle {d['idle_ms']:.3f} ms a step; device time launched in a "
          f"step {d['in_step_pct']}%, in any span "
          f"{d['launched_in_span_pct']}%, launch found {d['found_pct']}%; "
          f"idle charged {d['idle_charged_pct']}%, gaps over 100 us "
          f"uncharged {d['gaps_over_100us_uncharged']}", file=log)
    print("spans (D): device idle ms a step by span: " + ", ".join(
        f"{k} {v:.3f}" for k, v in list(d["idle_by_span_ms"].items())[:10]),
        file=log)
    print("spans (D): device ms a step by span: " + ", ".join(
        f"{k} {v:.3f}" for k, v in list(d["by_span_ms"].items())[:12]),
        file=log)


def read(ctx):
    """`ctx.spans`, measured on the first call."""
    if not hasattr(ctx, "spans"):
        ctx.spans = measure(ctx)
    return ctx.spans
