"""The least work of each call of the program's kernel ops
(`transmf::<op>`), from the shapes and dtypes the profiler records for the
call: bytes (every input tensor read once, every output written once) and
operations (the products and sums the function needs), and which peak the
operations are held to ("mma": the tensor cores' rate for bfloat16 inputs;
the CUDA cores' float32 rate otherwise). The least time is the larger of
bytes over the HBM rate and operations over that peak. The arithmetic is
that of `chip_smoke.py`'s `_bound` and its cases' `work` functions.

The 13 ops in `OPS` are counted here; any other op is counted by
`ops/<op>.py`, whose `outputs(shapes)` and `ops(shapes)` keep the contracts
of `_outputs` and `_ops`. An op with neither has no count.
"""

from __future__ import annotations

import functools
import importlib
import importlib.util
import math

from .. import peaks

ITEMSIZE = {"c10::BFloat16": 2, "c10::Half": 2, "float": 4, "double": 8,
            "long int": 8, "int": 4, "bool": 1, "unsigned char": 1,
            "signed char": 1, "short int": 2}
COMPUTE = {"c10::BFloat16": "bfloat16", "c10::Half": "float16",
           "float": "float32"}


def _numel(shape):
    return math.prod(shape)


def _outputs(op, shapes):
    """[(shape, same-dtype-as-input-0 or 'float')] of the op's outputs."""
    s = shapes
    if op == "token_pool":
        return [((s[0][0], 4 * s[0][2]), None)]
    if op == "attention":
        return [(s[0], None)]
    if op == "flash_fwd":
        return [(s[0], None), (s[0][:3], "float")]
    if op == "flash_dq":
        return [(s[0], None)]
    if op == "flash_dkv":
        return [(s[1], None), (s[2], None)]
    if op in ("stem_conv", "stem_conv_stats"):
        out = [((*s[0], s[1][3]), None)]
        return out + ([((2, s[1][3]), "float")] if op.endswith("stats")
                      else [])
    if op == "stem_dw":
        return [((3, 3, 3, s[1][-1]), "float")]
    if op == "affine_act_pool":
        b, x, y, z, c = s[0]
        return [((b, x // 2, y // 2, z // 2, c), None)]
    if op == "affine_act_pool_bwd":
        return [(s[0], None), ((2, _numel(s[1])), "float")]
    if op in ("band_conv", "band_conv_stats"):
        out = [((*s[0][:4], s[1][4]), None)]
        return out + ([((2, s[1][4]), "float")] if op.endswith("stats")
                      else [])
    if op == "band_dw":
        return [((3, 3, 3, s[0][4], s[1][4]), "float")]
    raise KeyError(op)


def _ops(op, s):
    """(operations, 'mma' or 'f32')"""
    if op == "token_pool":
        return 2 * (_numel(s[0]) + _numel(s[1])), "f32"
    if op in ("attention", "flash_fwd"):
        return 4 * _numel(s[0]) * s[1][2], "mma"
    if op == "flash_dq":  # s, dp and ds k
        return 6 * _numel(s[0]) * s[1][2], "mma"
    if op == "flash_dkv":  # s, dp, p^T g and ds^T q
        return 8 * _numel(s[0]) * s[1][2], "mma"
    if op in ("stem_conv", "stem_conv_stats"):
        return 2 * 27 * _numel(s[0]) * s[1][3], "mma"
    if op == "stem_dw":
        return 2 * 27 * _numel(s[1]), "mma"
    if op == "affine_act_pool":  # multiply, add, select, max or add
        return 4 * _numel(s[0]), "f32"
    if op == "affine_act_pool_bwd":
        return 10 * _numel(s[0]), "f32"
    if op in ("band_conv", "band_conv_stats"):
        return 2 * 27 * _numel(s[0]) * s[1][4], "mma"
    if op == "band_dw":
        return 2 * 27 * _numel(s[0]) * s[1][4], "mma"
    raise KeyError(op)


OPS = ("token_pool", "attention", "flash_fwd", "flash_dq", "flash_dkv",
       "stem_conv", "stem_conv_stats", "stem_dw", "affine_act_pool",
       "affine_act_pool_bwd", "band_conv", "band_conv_stats", "band_dw")


def count_of(op: str):
    """(outputs, ops) of transmf::<op>, each a function of the recorded
    shapes, or None where nothing counts the op."""
    if op in OPS:
        return functools.partial(_outputs, op), functools.partial(_ops, op)
    name = f"{__package__}.ops.{op}"
    if importlib.util.find_spec(name) is None:
        return None
    mod = importlib.import_module(name)
    return mod.outputs, mod.ops


def least_time_s(op: str, shapes, dtypes) -> tuple[float, str] | None:
    """(seconds, 'bytes' or 'operations') of one call of transmf::<op>
    with the recorded input `shapes` and `dtypes` (one entry per schema
    argument; an absent optional tensor or a scalar has an empty shape),
    or None where the op has no count."""
    count = count_of(op)
    if count is None:
        return None
    outputs, operations = count
    tensors = [(sh, dt) for sh, dt in zip(shapes, dtypes)
               if sh and dt in ITEMSIZE]
    first = tensors[0][1]
    nbytes = sum(_numel(sh) * ITEMSIZE[dt] for sh, dt in tensors)
    for shape, dt in outputs([sh for sh, _ in zip(shapes, dtypes)]):
        nbytes += _numel(shape) * ITEMSIZE[dt or first]
    ops, kind = operations(shapes)
    peak = (peaks.FLOPS[COMPUTE[first]] if kind == "mma"
            else peaks.FLOPS["float32"])
    by_bytes, by_ops = nbytes / peaks.HBM_BYTES_PER_S, ops / peak
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")
