"""What the per-layer metrics' readers share. A reader is
`metrics/<metric>.py` with `read(ctx) -> float | None`; `ctx` holds the
traced stretch (`ctx.trace`, a `profiling.Trace`, or None), the untraced
window's seconds and units (`ctx.window_s`, `ctx.units`), the pairs a unit
(`ctx.pairs_per_unit`), the configuration and mix (`ctx.cfg`, `ctx.mix`)
and the FLOPs of one pair's unit of work (`ctx.flops_per_pair`). A reader
that finds nothing to read returns None and the metric is left out."""

from __future__ import annotations

from . import peaks


def traced(ctx):
    """The traced stretch, if it saw the device work."""
    t = ctx.trace
    return t if t is not None and t.busy_s > 0 and t.units else None


def idle_pct(ctx):
    t = traced(ctx)
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def mfu_pct(ctx):
    """The model's FLOPs for the pairs of the untraced window, over its
    seconds, over the card's dense peak in the compute dtype (a run whose
    trace saw no device reads nothing)."""
    if traced(ctx) is None or not ctx.units or ctx.window_s <= 0:
        return None
    flops = ctx.flops_per_pair * ctx.units * ctx.pairs_per_unit
    return 100.0 * flops / ctx.window_s / peaks.FLOPS[ctx.cfg["compute_dtype"]]


def kernels_roofline_pct(ctx):
    """The transmf:: ops' least time over their kernels' device time."""
    t = traced(ctx)
    if t is None or t.op_device_s <= 0:
        return None
    return 100.0 * t.op_least_s / t.op_device_s


def op_roofline_pct(ctx, names):
    """The named transmf:: ops' least time over their kernels' device time
    (`profiling.Trace.by_op`): one kernel's share of its roofline, for a
    reader `metrics/<kernel>_roofline.<kind>.py`. None where none of them
    ran, or one of them has no count."""
    t = traced(ctx)
    if t is None or any(n in t.uncounted for n in names):
        return None
    ran = [t.by_op[n] for n in names if n in t.by_op]
    device_s = sum(b["device_s"] for b in ran)
    if device_s <= 0:
        return None
    return 100.0 * sum(b["least_s"] for b in ran) / device_s


def per_unit_ms(seconds, ctx):
    t = traced(ctx)
    return None if t is None else 1e3 * seconds / t.units
