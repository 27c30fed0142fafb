"""Host ms a train step inside the program's "sync" spans: the host
blocked on a device read (the augmentation's draws), in `spans.py`'s
stretch S, no profiler."""
from portbench import spans


def read(ctx):
    s = spans.read(ctx)
    return None if s is None else s.sync_wait_ms
