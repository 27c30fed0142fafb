"""The data axis of the JAX package's mesh, over a process group.

Port of transmf_ad_tpu/parallel/mesh.py for data parallelism. JAX's
`make_hybrid_mesh({"data": n, "model": 1})` is the world of W ranks: the
batch axis splits into W equal slices of the padded global batch
(`padded_batch`, `distributed.rank_slice`), and the train state is
replicated, every rank holding the whole model. `shard_state` replicates
it by broadcasting rank 0's parameters, buffers and optimizer state, after
`init_state` and after any load, as JAX's `shard_state` places the state
on the mesh. The tensor-parallel 'model' axis (`param_shardings`) is not
ported yet (ROADMAP.md Queue 1 item 10).
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist

from .distributed import collective_flat


def padded_batch(n: int, world: int) -> int:
    """The global batch size a batch of `n` is padded to: the next multiple
    of the world size."""
    return -(-n // world) * world


def _optimizer_tensors(optimizer) -> List[torch.Tensor]:
    """The optimizer's state tensors in parameter order (none before its
    first step)."""
    out = []
    for group in optimizer.param_groups:
        for p in group["params"]:
            for _, v in sorted(optimizer.state.get(p, {}).items()):
                if isinstance(v, torch.Tensor):
                    out.append(v)
    return out


def shard_state(state, group):
    """Replicate a `TrainState` over `group` from rank 0: the model's
    parameters and buffers and the optimizer's state. The generator stays
    per rank (each draws its own augmentation and dropout). A no-op without
    a group."""
    if group is None:
        return state
    device = next(state.model.parameters()).device
    tensors = [*state.model.parameters(), *state.model.buffers(),
               *_optimizer_tensors(state.optimizer)]
    collective_flat(tensors, lambda flat: dist.broadcast(flat, 0,
                                                         group=group),
                    device)
    return state
