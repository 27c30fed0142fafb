"""Host us a `transmf::` op call in its registered implementation
(checks, variant, launch): the program's `op.<name>.host_ns` counters over
its `op.<name>.calls`, summed over the ops, in `spans.py`'s stretch S."""
from portbench import spans


def read(ctx):
    s = spans.read(ctx)
    return None if s is None else s.op_dispatch_us
