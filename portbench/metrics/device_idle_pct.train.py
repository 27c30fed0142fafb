"""Share of the traced train steps' wall time with no kernel or copy on
the card (the union of device intervals)."""
from portbench import readers


def read(ctx):
    return readers.idle_pct(ctx)
