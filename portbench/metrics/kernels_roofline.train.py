"""The hand-written kernels' share of their roofline in the traced train
steps: the sum over transmf:: op calls of the least time their shapes
allow (`counts/kernels.py`), over the device time of their kernels. An op
with no count is left out of both sums."""
from portbench import readers


def read(ctx):
    return readers.kernels_roofline_pct(ctx)
