"""K14's share of its roofline in the traced train steps: the least time
of the transmf::window_attention and transmf::window_attention_bwd calls
(`counts/ops/window_attention.py`, `counts/ops/window_attention_bwd.py`)
over their kernels' device time. None where neither ran."""
from portbench import readers


def read(ctx):
    return readers.op_roofline_pct(ctx, ["window_attention",
                                         "window_attention_bwd"])
