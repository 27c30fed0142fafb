"""Device ms a train step launched inside the program's "window attention"
spans: each Swin block's norm1, qkv, K14's forward and proj (`spans.py`'s
stretch D, a device-only profiler). The backward is not split by span, so
this is the forward's share. None without a card or where no such span
ran."""
from portbench import spans


def read(ctx):
    s = spans.read(ctx)
    if s is None or s.device is None:
        return None
    return s.device["by_span_ms"].get("window attention")
