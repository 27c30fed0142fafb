"""Training over torch.distributed: one process per GPU.

Port of transmf_ad_tpu/parallel/distributed.py. The JAX package runs one
SPMD program under `shard_map` over a mesh's 'data' axis, one process per
host; here each rank is a process with one card (rank r on `cuda:{local
rank}`), in a torch.distributed process group whose world is the 'data'
axis (`mesh.py` splits it into data and model groups for a tensor-parallel
'model' axis). The psums of the JAX step (BatchNorm statistics, loss
terms, gradients) become all-reduces over the data group: NCCL between
cards, Gloo on the CPU (and for ranks that share one card, which NCCL
refuses).

What this module holds is the host-side plumbing:

- `init_distributed`: join the group from the Trainer's fields / the CLI's
  flags (`--coordinator_address`, `--num_processes`, `--process_id`), or
  from torchrun's environment with `--coordinator_address auto`, before
  any other CUDA call; a finite timeout makes a dead rank fail the others
  instead of hanging them;
- `place_global`: this rank's rows of a global batch (every rank's loader
  yields the same global batch; each copies only its own rows);
- `fetch_global`: the inverse for the small per-sample step outputs
  (logits, labels, masks, probabilities; never volumes): an all-gather,
  back in the global batch's order on every rank;
- `is_primary` / `NullLogger`: checkpoint writes, log files and partition
  snapshots belong to rank 0.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

# how long a collective waits for the other ranks before it fails
TIMEOUT = datetime.timedelta(seconds=300)


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None, device="cuda",
                     timeout: datetime.timedelta = TIMEOUT) -> bool:
    """Join the process group; True when one is up. Call before any other
    CUDA call.

    Three modes, as in the JAX package:
      - no arguments, or one process with no coordinator: a no-op (False);
        single-process behaviour is unchanged;
      - `coordinator_address='auto'`: torchrun's environment (RANK,
        WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT);
      - `host:port` (or `tcp://host:port`) with `num_processes` and
        `process_id`: a TCP rendezvous at that address.

    backend: None picks "nccl" for a CUDA `device` and "gloo" for the CPU;
    "gloo" on CUDA serves ranks that share one card (NCCL refuses them).
    On CUDA the rank's card (LOCAL_RANK, or `process_id` modulo the cards
    on the host) becomes the current device first.
    Idempotent: with the group already up it returns True."""
    if dist.is_initialized():
        return True
    if coordinator_address in (None, "") and num_processes is None:
        return False
    if num_processes is not None and int(num_processes) <= 1 \
            and coordinator_address in (None, "", "auto"):
        return False
    if coordinator_address in (None, ""):
        raise ValueError(f"num_processes={num_processes} needs a "
                         "coordinator address")
    cuda = torch.device(device).type == "cuda"
    backend = backend or ("nccl" if cuda else "gloo")
    if coordinator_address == "auto":
        if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
            raise RuntimeError(
                "coordinator_address='auto' reads torchrun's environment "
                "(RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT), which is not "
                "set; launch with torchrun or pass host:port, "
                "num_processes and process_id")
        local = int(os.environ.get("LOCAL_RANK", os.environ["RANK"]))
        kw = dict(init_method="env://")
    else:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes and "
                             "process_id")
        addr = coordinator_address
        if not addr.startswith("tcp://"):
            addr = f"tcp://{addr}"
        local = int(process_id)
        kw = dict(init_method=addr, world_size=int(num_processes),
                  rank=int(process_id))
    if cuda:
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, timeout=timeout, **kw)
    return True


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """True on the process that owns side effects (checkpoints, logs)."""
    return process_index() == 0


def world_group():
    """The group the data-parallel collectives run over, or None when no
    group is up (single process)."""
    return dist.group.WORLD if dist.is_initialized() else None


def shutdown():
    """Leave the process group, if one is up."""
    if dist.is_initialized():
        dist.destroy_process_group()


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of `x` over the ranks of `group` (`x` itself without one),
    differentiable with psum's transpose: its backward all-reduces the
    cotangent."""
    if group is None:
        return x
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(x, group=group)


def collective_flat(tensors: List[torch.Tensor], collective, device=None):
    """Run `collective`, an in-place function of one 1-D tensor, on
    `tensors` laid end to end (one call per dtype, through `device` when
    given: NCCL moves only CUDA tensors) and copy the result back into
    each tensor in place."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1).to(device) for t in ts])
        collective(flat)
        off = 0
        with torch.no_grad():
            for t in ts:
                t.copy_(flat[off:off + t.numel()].view_as(t))
                off += t.numel()


def rank_slice(n: int, world: int, rank: int) -> slice:
    """Rank `rank`'s rows of a global batch of `n` rows (n a multiple of
    `world`): the rank-th of `world` equal slices."""
    if n % world:
        raise ValueError(f"a batch of {n} does not split over {world} ranks")
    per = n // world
    return slice(rank * per, (rank + 1) * per)


def place_global(batch: Dict, world: Optional[int] = None,
                 rank: Optional[int] = None) -> Dict:
    """This rank's rows of a host global batch whose leading axes are
    padded to a multiple of the world size: numpy arrays stay numpy arrays,
    tensors stay tensors, and a non-array entry (the '_n_real' count) is
    kept as it is. Single-process it is the batch itself."""
    world = process_count() if world is None else world
    rank = process_index() if rank is None else rank
    if world == 1:
        return batch
    out = {}
    for k, v in batch.items():
        if isinstance(v, (np.ndarray, torch.Tensor)) and v.ndim:
            v = v[rank_slice(v.shape[0], world, rank)]
        out[k] = v
    return out


def fetch_global(x: torch.Tensor, parts: int, group) -> np.ndarray:
    """Every rank's rows of a step output, in the global batch's order, as
    numpy on every rank.

    `x` holds this rank's rows of `parts` consecutive global batches, one
    after the other (the same count each, as a padded feed gives them): the
    result is the batches' global rows, batch by batch, gathered over
    `group` (None: `x` alone, on the host)."""
    if group is None:
        return _host(x)
    world = dist.get_world_size(group)
    if x.is_floating_point():
        x = x.float()  # Gloo's all-gather has no bfloat16 on every build
    got = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(got, x.contiguous(), group=group)
    per = x.shape[0] // parts
    # (world, parts, per, ...) -> (parts, world, per, ...)
    stacked = torch.stack([g.reshape(parts, per, *x.shape[1:]) for g in got],
                          dim=1)
    return _host(stacked.reshape(-1, *x.shape[1:]))


def _host(x: torch.Tensor) -> np.ndarray:
    x = x.detach()
    return (x.float() if x.is_floating_point() else x).cpu().numpy()


class NullLogger:
    """Logger interface for non-primary ranks: no file, no stdout. Every
    rank runs the same training loop; only rank 0 writes log.txt and
    echoes to the console."""

    def print_message(self, msg: str):
        pass

    def print_message_nocli(self, msg: str):
        pass
