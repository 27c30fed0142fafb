"""Operations and bytes counted from shapes: the model's FLOPs for the
work a cell does (`model`) and each kernel op's least work (`kernels`)."""
