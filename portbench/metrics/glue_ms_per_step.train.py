"""Device ms a train step of PyTorch's own kernels (neither the program's
hand-written kernels nor cuDNN / cuBLAS): the glue around the kernels."""
from portbench import readers


def read(ctx):
    t = readers.traced(ctx)
    return None if t is None else readers.per_unit_ms(
        t.by_kind_s["PyTorch"], ctx)
