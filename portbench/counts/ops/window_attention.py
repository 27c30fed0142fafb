"""transmf::window_attention (K14's forward), from its recorded shapes:
qkv (B, X, Y, Z, 3C) and the table (T, heads) of a cubic full window W
(T = (2W - 1)^3). The window is MONAI's get_window_size of the grid (an
axis at most W takes the grid's size), n its tokens, and the grid padded
to whole windows. Every window row is computed, the padded ones too, so
the operations are QK^T and P V over each (window, head): 4 * n * n * 16.
Outputs: the output (B, X, Y, Z, C) and the float32 logsumexp (B *
windows, heads, n)."""

from __future__ import annotations

import math

HEAD_DIM = 16


def geometry(shapes):
    """(windows of the batch, heads, n) of a call."""
    b, *grid, _ = shapes[0]
    t, heads = shapes[2]
    w = (round(t ** (1 / 3)) + 1) // 2
    ws = [g if g <= w else w for g in grid]
    windows = b * math.prod(-(-g // s) for g, s in zip(grid, ws))
    return windows, heads, math.prod(ws)


def outputs(shapes):
    windows, heads, n = geometry(shapes)
    qkv = shapes[0]
    return [((*qkv[:4], qkv[4] // 3), None), ((windows, heads, n), "float")]


def ops(shapes):
    windows, heads, n = geometry(shapes)
    return 4 * windows * heads * n * n * HEAD_DIM, "mma"
