"""transmf::window_attention_bwd (K14's backward), from its recorded
shapes: qkv, qkv_bias, the table, the output, the logsumexp (B * windows,
heads, n) and the output's gradient. The kernel recomputes S and dP = g
V^T twice, once with the query rows resident (dQ += dS K) and once with
the keys (dV += P^T g, dK += dS^T Q), as K11 and K12 do: seven products of
2 * n * n * 16 a (window, head). Outputs: dqkv like qkv, and the float32
gradients of qkv_bias and of the table."""

from __future__ import annotations

import math

HEAD_DIM = 16


def outputs(shapes):
    return [(shapes[0], None), (shapes[1], "float"), (shapes[2], "float")]


def ops(shapes):
    lse = shapes[4]
    return 14 * math.prod(lse) * lse[2] * HEAD_DIM, "mma"
