"""The train step's model FLOPs a second (forward and backward,
`counts/model.py::train_per_pair`) over the card's dense bf16 peak."""
from portbench import readers


def read(ctx):
    return readers.mfu_pct(ctx)
