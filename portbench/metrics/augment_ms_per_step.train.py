"""Device ms a train step of the kernels, copies and sets launched inside
the program's "augment" spans (`spans.py`'s stretch D, a device-only
profiler; None without a card)."""
from portbench import spans


def read(ctx):
    s = spans.read(ctx)
    return None if s is None else s.augment_ms
