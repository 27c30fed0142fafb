"""SwinUNETRClassifier's forward FLOPs a pair, counted the way MONAI's
swinViT computes: the patch embedding (the stem, the model's one conv);
per block qkv, proj and the window products (4 * n * C a token: QK^T and
P V over the window's n tokens) over the padded grid, which MONAI
computes and crops, and the MLP over the real one; each stage's merging
(Linear(8C, 2C) a merged token) and the head."""

from __future__ import annotations

import math


def _window(grid, window):
    """MONAI's get_window_size: an axis at most the window takes the
    grid's size."""
    return [g if g <= window else window for g in grid]


def forward_per_pair(cfg: dict, volume) -> dict:
    m = cfg["model"]
    p, c, window = m["patch_size"], m["feature_size"], m["window_size"]
    grid = [-(-v // p) for v in volume]
    stem = 2 * m["in_channels"] * p ** 3 * c * math.prod(grid)
    rest = 0
    for depth in m["depths"]:
        ws = _window(grid, window)
        n = math.prod(ws)
        padded = math.prod(-(-g // w) * w for g, w in zip(grid, ws))
        tokens = math.prod(grid)
        hidden = int(c * m["mlp_ratio"])
        block = (2 * padded * c * 3 * c + 4 * padded * n * c
                 + 2 * padded * c * c + 2 * 2 * tokens * c * hidden)
        grid = [-(-g // 2) for g in grid]
        rest += depth * block + 2 * math.prod(grid) * 8 * c * 2 * c
        c *= 2
    rest += 2 * c * m["num_classes"]
    return {"conv": stem, "stem": stem, "rest": rest}
