"""The model's floating-point operations, counted from the configuration's
widths and the volume's shape: each conv (2 * Cin * Cout * k^3 per output
voxel), each linear (2 * in * out per token) and each attention product
(QK^T and PV: 4 * queries * keys * heads * dim_head). Elementwise work,
normalisation and pooling are not counted. A train step is the forward,
the gradient of every weight (as much again) and the gradient of every
activation (as much again) but the input volume's, which nothing needs:
3 x forward less one stem forward per encoder. Recomputation is not
counted."""

from __future__ import annotations

import importlib
import importlib.util

# sNet's convs: (cin, cout as multiples of dim / 4 (0: one channel),
# kernel, whether a 2^3 pool follows)
SNET = ((0, 1, 3, True), (1, 1, 3, False), (1, 2, 3, True), (2, 2, 3, False),
        (2, 4, 3, True), (4, 8, 3, False), (8, 4, 1, True))


def snet(dim: int, volume) -> tuple[list, tuple]:
    """Per-conv forward FLOPs of one encoder on one volume, and the token
    grid it leaves."""
    q = dim // 4
    spatial, flops = list(volume), []
    for ci, co, k, pool in SNET:
        cin, cout = (ci * q if ci else 1), co * q
        vox = spatial[0] * spatial[1] * spatial[2]
        flops.append(2 * cin * cout * k ** 3 * vox)
        if pool:
            spatial = [s // 2 for s in spatial]
    return flops, tuple(spatial)


def transformer_layer(n: int, m: int, dim: int, heads: int, dim_head: int,
                      mlp_dim: int) -> int:
    """One layer, n query tokens over m context tokens."""
    inner = heads * dim_head
    return (2 * n * dim * inner + 2 * m * dim * 2 * inner
            + 4 * n * m * inner + 2 * n * inner * dim
            + 2 * 2 * n * dim * mlp_dim)


def forward_per_pair(cfg: dict, volume) -> dict:
    """{'conv': ..., 'stem': ..., 'rest': ...} forward FLOPs of one MRI +
    PET pair; 'stem' is the two first convs (part of 'conv'). The count is
    that of `models/<reference>.py`, by the configuration's `"reference"`:
    a new architecture adds its own file and may use `snet` and
    `transformer_layer` or count its whole model itself."""
    ref = cfg["reference"]
    name = f"{__package__}.models.{ref}"
    if importlib.util.find_spec(name) is None:
        raise ValueError(
            f"no count for reference {ref!r}: add portbench/counts/models/"
            f"{ref}.py with forward_per_pair(cfg, volume) -> "
            "{'conv', 'stem', 'rest'}")
    return importlib.import_module(name).forward_per_pair(cfg, volume)


def train_per_pair(cfg: dict, volume) -> int:
    f = forward_per_pair(cfg, volume)
    total = f["conv"] + f["rest"]
    return 3 * total - f["stem"]

