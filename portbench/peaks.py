"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit): what every roofline and mfu share
is taken against."""

HBM_BYTES_PER_S = 3.35e12
FLOPS = {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12,
         "float32": 67e12, "fp8": 1979e12}
