"""Column-parallel compute over the 'model' axis: the slices and the
collectives that join them.

JAX places a weight on the mesh's 'model' axis and XLA's partitioner splits
the products; PyTorch has no partitioner, so the layers split themselves
(`nn/blocks.py::conv_bn_act`, `nn/attention.py::Linear` and `Attention`).
A sharded parameter holds the rank's rows on its rank (its output channels:
dimension 0 of a conv or dense weight, the last one of any other
parameter) and carries a `Shard`, which says how the rows were cut and over
which process group they are joined. The layer computes its rank's output
channels, and the channels are all-gathered where the next layer needs all
of them. The rows of a dimension of n are cut into `blocks` equal blocks
(1 but for an attention's k | v projection, whose blocks are k and v), and
each block into `size` equal parts; the rank holds part `index` of every
block, in block order.

Autograd follows two rules, which keep every replicated activation's
cotangent complete and the same on every rank of the model group:

- `gather` (slices -> replicated): its backward takes the rank's rows of
  the (complete) cotangent;
- `copy_in` (replicated input of a sharded layer): identity forward, and
  its backward sums the cotangent over the model group, since a layer that
  computes only the rank's channels sees only their share of it.

A sharded weight's gradient is then complete on its rank. A replicated
parameter that a sharded layer uses on its slice (the layer's bias, a
BatchNorm's scale and shift; `local`) gets a gradient on the slice alone:
`reduce_partial_grads` sums those over the model group after the backward.
Such a parameter must not also be used whole. Gloo moves bfloat16 and
float16 as float32 (not every build has them).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.distributed as dist


class ModelAxis:
    """The 'model' axis of one rank: its process group, the axis size and
    this rank's index on it, and the replicated parameters that sharded
    layers have used on a slice (`local`), in the order of first use."""

    def __init__(self, group, size: int, index: int):
        self.group, self.size, self.index = group, size, index
        self.partial: Dict[int, torch.nn.Parameter] = {}

    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        """`x` itself; in the backward its cotangent is summed over the
        model group."""
        if not x.requires_grad:
            return x
        return _CopyIn.apply(x, self.group)


class Shard:
    """How one parameter is split over a `ModelAxis`: along `dim`, in
    `blocks` blocks of `full // blocks` rows, the rank holding part
    `axis.index` of each block."""

    def __init__(self, axis: ModelAxis, dim: int, full: int,
                 blocks: int = 1):
        if full % (blocks * axis.size):
            raise ValueError(f"{full} rows do not split into {blocks} "
                             f"blocks over {axis.size} ranks")
        self.axis, self.dim, self.full, self.blocks = axis, dim, full, blocks

    def rows(self, t: torch.Tensor, dim: Optional[int] = None):
        """This rank's rows of a full `t` along `dim` (the shard's)."""
        dim = self.dim if dim is None else dim
        index = self.axis.index
        part = t.shape[dim] // (self.blocks * self.axis.size)
        if self.blocks == 1:
            return t.narrow(dim, index * part, part)
        return torch.cat([b.narrow(dim, index * part, part)
                          for b in t.chunk(self.blocks, dim)], dim)

    def join(self, parts: List[torch.Tensor], dim: Optional[int] = None):
        """The full tensor from every rank's rows along `dim`, in rank
        order: block by block, rank by rank."""
        dim = self.dim if dim is None else dim
        if self.blocks == 1:
            return torch.cat(parts, dim)
        chunks = [p.chunk(self.blocks, dim) for p in parts]
        return torch.cat([c[b] for b in range(self.blocks) for c in chunks],
                         dim)

    def gather(self, y: torch.Tensor, dim: Optional[int] = None):
        """All-gather this rank's rows `y` (along `dim`, the shard's) into
        the full tensor, differentiably: the backward takes the rank's rows
        of the cotangent."""
        dim = (self.dim if dim is None else dim) % y.dim()
        if not torch.is_grad_enabled() or not y.requires_grad:
            return self.join(all_gather(y, self.axis.group), dim)
        return _Gather.apply(y, self, dim)

    def local(self, p: torch.nn.Parameter) -> torch.Tensor:
        """This rank's rows of a replicated 1-D parameter `p` that a
        sharded layer uses on its slice; `p` is recorded for
        `reduce_partial_grads`."""
        self.axis.partial.setdefault(id(p), p)
        return self.rows(p, 0)


def shard_of(p) -> Optional[Shard]:
    """The `Shard` of a sharded parameter, else None."""
    return getattr(p, "model_shard", None)


def full(p: torch.Tensor) -> torch.Tensor:
    """A parameter whole: gathered over the model axis (differentiably)
    when it is sharded, else itself. For a sharded parameter used by
    replicated compute (ADVIT's positional embedding)."""
    s = shard_of(p)
    return p if s is None else s.gather(p)


def model_axis(model) -> Optional[ModelAxis]:
    """The `ModelAxis` `model`'s parameters are sharded over, or None."""
    for p in model.parameters():
        s = shard_of(p)
        if s is not None:
            return s.axis
    return None


def reduce_partial_grads(model) -> None:
    """Sum over the model group the gradients of the replicated parameters
    that sharded layers used on their slices (one all-reduce of them laid
    end to end): each rank's gradient covers its slice alone."""
    axis = model_axis(model)
    if axis is None:
        return
    grads = [p.grad for p in axis.partial.values() if p.grad is not None]
    if grads:
        from .distributed import collective_flat

        collective_flat(grads, lambda flat: flat.copy_(
            all_reduce(flat, axis.group)))


def _wire(t: torch.Tensor, group) -> torch.Tensor:
    """`t` in a dtype the group's backend moves."""
    if t.dtype in (torch.bfloat16, torch.float16) \
            and dist.get_backend(group) == "gloo":
        return t.float()
    return t.contiguous()


def all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's `t` (the same shape on each), in rank order."""
    w = _wire(t, group)
    parts = [torch.empty_like(w) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, w, group=group)
    return [p.to(t.dtype) for p in parts]


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of `t` over the ranks of `group`, as a new tensor."""
    w = _wire(t, group)
    w = w.clone() if w is t else w
    dist.all_reduce(w, group=group)
    return w.to(t.dtype)


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, shard, dim):
        ctx.shard, ctx.dim = shard, dim
        return shard.join(all_gather(y, shard.axis.group), dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.shard.rows(g, ctx.dim).contiguous(), None, None
