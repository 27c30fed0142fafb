"""ModelTransformerRes's forward FLOPs a pair: ModelAd's two sNet
encoders; 2 x depth fusion layers of N queries over both streams' 2N
tokens; the 2 * dim head, no discriminator."""

from __future__ import annotations

from ..model import snet, transformer_layer


def forward_per_pair(cfg: dict, volume) -> dict:
    m = cfg["model"]
    dim = m["dim"]
    convs, grid = snet(dim, volume)
    n = grid[0] * grid[1] * grid[2]
    args = (dim, m["heads"], m["dim_head"], m["mlp_dim"])
    fusion = 2 * m["depth"] * transformer_layer(n, 2 * n, *args)
    head = 2 * (2 * dim * 512 + 512 * 64 + 64 * 2)
    return {"conv": 2 * sum(convs), "stem": 2 * convs[0],
            "rest": fusion + head}
