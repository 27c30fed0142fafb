"""The JAX package's ('data', 'model') mesh, over process groups.

Port of transmf_ad_tpu/parallel/mesh.py. A mesh of `d x m` is `d * m`
ranks, rank r at data index r // m and model index r % m, so the ranks of
one model group are consecutive (one host's cards, as JAX's
`make_hybrid_mesh` keeps a model group inside a host). Each rank belongs
to one data group (the ranks of its model index) and one model group (the
ranks of its data index):

- the data axis splits the batch into equal slices of the padded global
  batch (`padded_batch`, `distributed.rank_slice`); BatchNorm moments,
  losses, gradient means and the eval metrics are summed over the data
  group;
- the model axis is tensor parallelism: `param_shardings` names the
  weights JAX's rule column-shards, `shard_state` keeps each rank's rows
  of them (and of their optimizer moments), and the sharded layers compute
  their rank's channels (`parallel/tensor.py`). Everything else is
  replicated, broadcast from rank 0 after `init_state` and after any load,
  as JAX's `shard_state` places the state on the mesh.

Checkpoints stay layout-free: `full_state_dict` gathers the rows, and
`load_state_dict` takes this rank's rows of a full state_dict.

JAX's `batch_sharding`, `replicated` and `put_replicated` have no
counterpart: torch has no sharding objects. A batch's rows are placed by
`distributed.place_global` with the mesh's data size and index, and the
replicated state is broadcast by `shard_state`. Where JAX's `make_mesh`
uses the first devices of a larger set, a process cannot be left out: a
mesh must cover the world exactly.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch
import torch.distributed as dist
from torch import nn

from .distributed import collective_flat
from .tensor import ModelAxis, Shard, all_gather, shard_of


def padded_batch(n: int, world: int) -> int:
    """The global batch size a batch of `n` is padded to: the next multiple
    of the world size."""
    return -(-n // world) * world


@dataclass
class Mesh:
    """This rank's view of a ('data', 'model') mesh: the axis sizes, its
    index on each, the data group (None with one data index) and the model
    axis (None with one model index)."""
    shape: Dict[str, int]
    data_index: int = 0
    data_group: object = None
    axis: Optional[ModelAxis] = field(default=None, repr=False)

    @property
    def data(self) -> int:
        return self.shape["data"]

    @property
    def model(self) -> int:
        return self.shape.get("model", 1)


def make_mesh(axes: Optional[Dict[str, int]] = None) -> Mesh:
    """The mesh of axes {'data': d, 'model': m} over the process group's
    world (one process without a group), e.g. {'data': 2, 'model': 2};
    None puts every rank on 'data', and one size of -1 is inferred from
    the world size (like a reshape). A mesh larger than the world raises
    `ValueError`, as JAX's does; one smaller raises too (JAX would use
    the first devices; a process cannot be left out). Every rank calls it,
    in the same order: it creates the process groups."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    axes = dict(axes or {"data": world})
    if set(axes) - {"data", "model"} or "data" not in axes:
        raise ValueError(f"mesh axes are 'data' and 'model', got "
                         f"{list(axes)}")
    known = math.prod(s for s in axes.values() if s != -1)
    axes = {k: (world // known if s == -1 else int(s))
            for k, s in axes.items()}
    n = math.prod(axes.values())
    if n > world:
        raise ValueError(f"mesh {axes} needs {n} processes, have {world}")
    if n < world:
        raise ValueError(f"mesh {axes} covers {n} of {world} processes; "
                         "every process must be on the mesh")
    d, m = axes["data"], axes.get("model", 1)
    rank = dist.get_rank() if dist.is_initialized() else 0
    mesh = Mesh(axes, data_index=rank // m)
    if world == 1:
        return mesh
    if m == 1:
        mesh.data_group = dist.group.WORLD
        return mesh
    for j in range(m):  # every rank creates every group, in one order
        g = (dist.new_group([i * m + j for i in range(d)]) if d > 1
             else None)
        if j == rank % m:
            mesh.data_group = g
    for i in range(d):
        g = dist.new_group([i * m + j for j in range(m)]) if d > 1 \
            else dist.group.WORLD
        if i == rank // m:
            mesh.axis = ModelAxis(g, m, rank % m)
    return mesh


def make_hybrid_mesh(axes: Dict[str, int]) -> Mesh:
    """`make_mesh` with the data axis first: the JAX package's DCN-aware
    layout, in which a model group stays inside one host. One process per
    card with consecutive ranks on a host (torchrun's order) gives that
    here when the model size divides the cards of a host."""
    if list(axes)[0] != "data":
        raise ValueError(f"the data axis comes first, got {list(axes)}")
    return make_mesh(axes)


def _shard_dim(module: nn.Module, name: str) -> int:
    """The dimension of `module`'s parameter `name` that holds JAX's last
    one: a conv or dense weight's output channels are torch's dimension 0
    (JAX's DHWIO and (in, out) end in them); any other parameter has JAX's
    layout."""
    if name == "weight" and isinstance(module, (nn.Conv3d, nn.Linear)):
        return 0
    return -1


def param_shardings(model: nn.Module, mp: int,
                    min_size: int = 2048) -> List[str]:
    """The names of the parameters JAX's rule column-shards over a model
    axis of `mp`: every parameter of at least 2 dimensions and `min_size`
    elements whose output dimension (`_shard_dim`) `mp` divides. Biases and
    norm scales are 1-D and stay replicated; with `mp` 1 nothing is
    sharded."""
    names = []
    if mp <= 1:
        return names
    for prefix, module in model.named_modules():
        for name, p in module.named_parameters(recurse=False):
            dim = _shard_dim(module, name)
            if p.ndim >= 2 and p.shape[dim] % mp == 0 \
                    and p.numel() >= min_size:
                names.append(f"{prefix}.{name}" if prefix else name)
    return names


def _owner(model: nn.Module, name: str):
    prefix, _, leaf = name.rpartition(".")
    return (model.get_submodule(prefix) if prefix else model), leaf


def shard_model(model: nn.Module, names: List[str], axis: ModelAxis):
    """Keep this rank's rows of the parameters `names` (whole on entry)
    and give each its `Shard`, on a `ModelAxis` of the model's own (the
    group, size and index of `axis`), whose record of the parameters used
    on a slice is the model's alone. A module's `shard_blocks` (an
    attention's k | v projection: 2) cuts its weight in blocks, each split
    over the ranks, where the rows allow it."""
    axis = ModelAxis(axis.group, axis.size, axis.index)
    for name in names:
        module, leaf = _owner(model, name)
        p = getattr(module, leaf)
        dim = _shard_dim(module, leaf) % p.ndim
        blocks = getattr(module, "shard_blocks", 1)
        if p.shape[dim] % (blocks * axis.size):
            blocks = 1
        shard = Shard(axis, dim, p.shape[dim], blocks)
        with torch.no_grad():
            p.data = shard.rows(p.data).clone()
        p.model_shard = shard
    return model


def _sharded(model) -> Dict[str, Shard]:
    """{name: Shard} of the model's sharded parameters, under every name a
    shared module gives them."""
    return {k: shard_of(p) for k, p in
            model.named_parameters(remove_duplicate=False)
            if shard_of(p) is not None}


def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """`model.state_dict()` with every sharded parameter gathered whole
    over the model axis. A collective: every rank of the model group calls
    it."""
    sd = model.state_dict()
    for k, s in _sharded(model).items():
        sd[k] = s.join(all_gather(sd[k], s.axis.group))
    return sd


def load_state_dict(model: nn.Module, sd: Dict[str, torch.Tensor]):
    """`model.load_state_dict(sd, strict=True)` from a full state_dict:
    a sharded parameter takes this rank's rows of its entry."""
    sharded = _sharded(model)
    sd = {k: (sharded[k].rows(v) if k in sharded else v)
          for k, v in sd.items()}
    return model.load_state_dict(sd, strict=True)


def _moments(optimizer) -> List[tuple]:
    """(parameter, key, tensor) of each per-parameter optimizer tensor,
    in parameter order (none before the first step)."""
    out = []
    for group in optimizer.param_groups:
        for p in group["params"]:
            for k, v in sorted(optimizer.state.get(p, {}).items()):
                if isinstance(v, torch.Tensor):
                    out.append((p, k, v))
    return out


def shard_optimizer(optimizer) -> None:
    """Cut the moments of sharded parameters to their rows, where they are
    still whole (after a load of a full optimizer state)."""
    for p, k, v in _moments(optimizer):
        s = shard_of(p)
        if s is not None and v.shape != p.shape and v.ndim == p.ndim:
            optimizer.state[p][k] = s.rows(v).clone()


def full_optimizer_state(optimizer) -> dict:
    """`optimizer.state_dict()` with the moments of sharded parameters
    gathered whole. A collective over the model group."""
    sd = optimizer.state_dict()
    params = [p for g in optimizer.param_groups for p in g["params"]]
    for i, p in enumerate(params):
        s = shard_of(p)
        if s is None or i not in sd["state"]:
            continue
        st = dict(sd["state"][i])
        for k, v in st.items():
            if isinstance(v, torch.Tensor) and v.shape == p.shape:
                st[k] = s.join(all_gather(v, s.axis.group))
        sd["state"][i] = st
    return sd


def shard_state(state, group, mesh: Optional[Mesh] = None):
    """Place a `TrainState` on the mesh: with a model axis, keep this
    rank's rows of the parameters `param_shardings` names (unless the
    model is sharded already, by `shard_model`) and of their optimizer
    moments, where they are still whole; then broadcast the replicated
    parameters, buffers and optimizer state from rank 0 of the world, and
    the rows of the sharded ones from rank 0 of the data group (`group`).
    The generator stays per rank. A no-op without a group and a model
    axis."""
    model, opt = state.model, state.optimizer
    axis = mesh.axis if mesh is not None else None
    if axis is not None and not _sharded(model):
        shard_model(model, param_shardings(model, axis.size), axis)
    shard_optimizer(opt)
    if not dist.is_initialized():
        return state
    device = next(model.parameters()).device
    rows = [p for p in model.parameters() if shard_of(p) is not None]
    rows += [v for p, _, v in _moments(opt) if shard_of(p) is not None]
    keep = {id(t) for t in rows}
    rep = [t for t in (*model.parameters(), *model.buffers(),
                       *(v for _, _, v in _moments(opt)))
           if id(t) not in keep]
    _broadcast(rep, dist.group.WORLD, device)
    if rows and group is not None:
        _broadcast(rows, group, device)
    return state


def _broadcast(tensors, group, device):
    src = dist.get_global_rank(group, 0)
    collective_flat(tensors, lambda flat: dist.broadcast(flat, src,
                                                         group=group),
                    device)
