"""Host ms a train step inside the program's "step" spans, less the
"sync" spans within them: the time the host takes to issue a step when it
does not wait on the device (`spans.py`'s stretch S, no profiler)."""
from portbench import spans


def read(ctx):
    s = spans.read(ctx)
    return None if s is None else s.host_issue_ms
