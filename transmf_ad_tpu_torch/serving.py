"""Serving: an eval-mode forward closed over a model: volumes -> probabilities.

Port of transmf_ad_tpu/serving.py:

- `make_inference_fn`: the eval forward on one device;
- `make_sharded_inference_fn`: the same over the ranks of a process group,
  each rank of the data axis serving its rows of every global batch, and
  with a model axis each rank of a model group computing its rows of the
  sharded weights' channels;
- `export_inference` / `load_inference`: the eval forward with its weights
  as a `torch.export` program in a `.pt2` file, which a serving process
  loads and calls without the model code. The program calls the kernels
  through their registered ops, so the loading process needs only
  `transmf_ad_tpu_torch.ops`; exported with CUDA example inputs it launches
  the kernels on the card, with CPU ones it runs their plain versions.

    export_inference(model, ("MRI", "PET"), path, input_shape)
    fn = load_inference(path)          # fn(mri, pet) -> (B, 2) probabilities

This module imports no model code at import time: a process that only
loads an artifact does not import `models`.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import torch


def resolve_dtype(dtype, device: torch.device) -> torch.dtype:
    """'auto' -> bfloat16 on CUDA, float32 elsewhere (the JAX package's
    `--dtype auto` picks bfloat16 on its accelerator); a torch.dtype is
    taken as it is."""
    if dtype == "auto":
        return torch.bfloat16 if device.type == "cuda" else torch.float32
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"dtype must be 'auto' or a torch.dtype, got "
                         f"{dtype!r}")
    return dtype


class InferenceModule(torch.nn.Module):
    """`make_inference_fn`'s forward as a module, the unit that
    `export_inference` exports: each volume cast to the compute dtype and
    given a trailing channel axis, the model's eval forward, the logits (the
    first of an adversarial model's three outputs), and their float32
    softmax."""

    def __init__(self, model, dtype: torch.dtype, adversarial: bool):
        super().__init__()
        self.model, self.dtype, self.adversarial = model, dtype, adversarial

    def forward(self, *vols):
        out = self.model(*(v.to(self.dtype)[..., None] for v in vols),
                         train=False)
        logits = out[0] if self.adversarial else out
        return torch.softmax(logits.float(), dim=-1)


def _module(model, device, dtype, adversarial) -> InferenceModule:
    """`model` on `device` in eval mode, wrapped; `adversarial` read from
    the registry (`models.ADVERSARIAL`) unless given, as it must be for a
    model the registry does not hold."""
    from .models import ADVERSARIAL, model_name

    if adversarial is None:
        adversarial = model_name(model) in ADVERSARIAL
    return InferenceModule(model.to(device), resolve_dtype(dtype, device),
                           adversarial).eval()


def make_inference_fn(model, device="cuda", dtype="auto",
                      adversarial: Optional[bool] = None):
    """Move `model` to `device` in eval mode and return fn(*vols): one
    (B, X, Y, Z) volume (tensor or array) per modality of the model, each
    given a trailing channel axis, -> (B, 2) float32 softmax probabilities
    on `device`; a wrong number of volumes raises from the model's forward.
    The forward computes in `dtype` with the model's float32 parameters. An
    adversarial model returns (logits, d_mri, d_pet) and the logits are
    taken from it; any other returns the logits.
    `adversarial` is read from the registry (`models.ADVERSARIAL`) unless it
    is given, as it must be for a model the registry does not hold."""
    device = torch.device(device)
    module = _module(model, device, dtype, adversarial)

    @torch.inference_mode()
    def infer(*vols):
        return module(*(torch.as_tensor(v).to(device=device,
                                              dtype=module.dtype)
                        for v in vols))

    return infer


def make_sharded_inference_fn(model, group=None, device="cuda", dtype="auto",
                              adversarial: Optional[bool] = None,
                              model_axis: int = 1):
    """The eval forward over the ranks of `group`, the JAX package's
    mesh-sharded serving. Every rank calls the returned fn(*vols) with the
    same global batch (host arrays or tensors), runs its rows
    (`parallel.rank_slice`) through `make_inference_fn`, and gets every
    rank's probabilities back in the global order (`parallel.fetch_global`):
    a (B, 2) float32 tensor on `device`, the same on every rank. Batch
    sizes must divide the data axis's size: a batch that does not raises
    `ValueError` on every rank before any collective (pad the last batch,
    as the feeds do for training). Without a group it is
    `make_inference_fn`.

    model_axis: the ranks of the world (`group` is then the world group or
    None) form the mesh {'data': W // model_axis, 'model': model_axis},
    and a copy of `model` keeps this rank's rows of the weights JAX's rule
    shards (`parallel.param_shardings`); `model` itself is left whole. A
    world that `model_axis` does not divide raises `ValueError`."""
    import torch.distributed as dist

    from .parallel import fetch_global, rank_slice

    if model_axis > 1:
        import copy

        from .parallel import make_mesh, param_shardings, shard_model

        if group not in (None, dist.group.WORLD):
            raise ValueError("make_sharded_inference_fn: a model axis is "
                             "laid over the world group")
        mesh = make_mesh({"data": -1, "model": model_axis})
        model = copy.deepcopy(model).to(torch.device(device))
        shard_model(model, param_shardings(model, model_axis), mesh.axis)
        group, world, rank = mesh.data_group, mesh.data, mesh.data_index
    elif group is None:
        return make_inference_fn(model, device, dtype, adversarial)
    else:
        world, rank = dist.get_world_size(group), dist.get_rank(group)
    infer = make_inference_fn(model, device, dtype, adversarial)

    def fn(*vols):
        rows = rank_slice(vols[0].shape[0], world, rank)
        probs = infer(*(v[rows] for v in vols))
        return torch.from_numpy(fetch_global(probs, 1, group)).to(
            probs.device)

    return fn


def export_inference(model, modalities: Sequence[str], path: str,
                     input_shape: Tuple[int, ...], batch_size=None,
                     input_dtype: torch.dtype = torch.float32,
                     adversarial: Optional[bool] = None, device="cuda",
                     dtype="auto") -> str:
    """Export `make_inference_fn`'s forward of `model` (on `device`, in the
    compute `dtype`) with its weights to a `.pt2` program at `path`, one
    (B, *input_shape) `input_dtype` input per modality, and return `path`.

    `batch_size=None` (default) exports a symbolic batch dimension shared
    by every input, as the JAX package's `symbolic_shape("b")`: the loaded
    program serves any batch size from 1 up. An int pins the batch: another
    batch size raises. Export where you serve: CUDA example inputs give a
    program that launches the kernels, CPU ones the plain versions."""
    device = torch.device(device)
    module = _module(model, device, dtype, adversarial)
    # a symbolic batch is traced from 2 rows: a size-1 example would
    # specialise the dimension
    b = 2 if batch_size is None else batch_size
    example = tuple(torch.zeros(b, *input_shape, dtype=input_dtype,
                                device=device) for _ in modalities)
    dynamic = None
    if batch_size is None:
        batch = torch.export.Dim("batch", min=1)
        dynamic = (tuple({0: batch} for _ in modalities),)  # (*vols,)
    program = torch.export.export(module, example, dynamic_shapes=dynamic,
                                  strict=False)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.export.save(program, path)
    return path


def load_inference(path: str):
    """Load an exported program; returns fn(*vols): host arrays or tensors,
    moved to the program's device and input dtype, -> (B, 2) float32
    probabilities on that device. Needs no model code: importing the ops
    registers what the program calls."""
    from . import ops  # noqa: F401  (registers the transmf:: ops)

    program = torch.export.load(path)
    inputs = set(program.graph_signature.user_inputs)
    first = next(n.meta["val"] for n in program.graph.nodes
                 if n.op == "placeholder" and n.name in inputs)
    module = program.module()

    @torch.inference_mode()
    def fn(*vols):
        return module(*(torch.as_tensor(v).to(device=first.device,
                                              dtype=first.dtype)
                        for v in vols))

    return fn
