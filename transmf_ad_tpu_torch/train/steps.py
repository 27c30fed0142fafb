"""The train step and its state.

Port of transmf_ad_tpu/train/steps.py::make_train_step. The JAX step is
one jitted program; here the same work runs eagerly on the model's device:
dequantize and augment the batch, forward with BatchNorm statistic updates
and dropout, the triple loss (CE + the mean of the two discriminator CEs,
from masked sums), backward, the optimizer step and the scheduler step,
each inside a span of `utils/tracing.py` ("step" around "prep",
"augment", "forward", "loss", "backward", "grad_reduce", "optimizer").
`make_eval_step` is the port of its eval step: the deterministic forward,
the per-sample cross-entropy and the masked metric accumulation.

Data parallel (the JAX package's `mesh=`, its step under `shard_map` over
the 'data' axis): with `group`, a torch.distributed process group, each
rank runs the step on its rows of the global batch. BatchNorm moments are
all-reduced over the group (`nn/batchnorm.py::synced`), and so are the
loss's sums (CE numerator and denominator, the two discriminator sums and
their count), with a differentiable all-reduce whose backward all-reduces
the cotangent (psum's transpose): each rank then holds the gradient of the
sum of the W replicated global losses, and one all-reduce of the flat
gradients divided by W (pmean) leaves the gradient of the global loss on
every rank, the same bits on each. Buffer donation has no counterpart.

Tensor parallel (the JAX package's 'model' axis, `parallel/mesh.py`): the
model's sharded layers compute their rank's channels and gather them
(`parallel/tensor.py`); `group` is then the data group, over which alone
the BatchNorm moments, the losses and the gradient means run. After the
backward the replicated parameters that sharded layers used on their
slices have their gradients summed over the model group
(`reduce_partial_grads`); a sharded weight's gradient is complete on its
rank. The ranks of one model group draw the same augmentation and dropout
(their generators are seeded alike), as JAX's key is replicated over
'model'.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from ..data.transforms import AugmentConfig, augment_batch, draw_uniforms
from ..nn import batchnorm
from ..nn.losses import adversarial_loss, cross_entropy
from ..parallel.distributed import collective_flat, psum
from ..parallel.tensor import reduce_partial_grads
from ..serving import resolve_dtype
from ..utils import tracing
from .metrics import MetricState
from .optim import build_optimizer


@dataclasses.dataclass
class TrainState:
    """Model (float32 master parameters), optimizer, scheduler, the
    generator that augmentation and dropout draw from, the compute dtype of
    the forward, and the number of steps taken."""
    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    generator: torch.Generator
    dtype: torch.dtype = torch.float32
    step: int = 0


def create_state(model: nn.Module, device="cuda", dtype="auto", seed: int = 0,
                 **optim_kw) -> TrainState:
    """Move `model` to `device` and build its optimizer (`build_optimizer`
    keywords) and a generator seeded with `seed` on that device. dtype:
    'auto' (bfloat16 on CUDA, float32 elsewhere) or a torch.dtype."""
    device = torch.device(device)
    model.to(device)
    opt, sched = build_optimizer(model.parameters(), **optim_kw)
    gen = torch.Generator(device=device).manual_seed(seed)
    return TrainState(model, opt, sched, gen, resolve_dtype(dtype, device))


def dequantize_input(v: torch.Tensor) -> torch.Tensor:
    """Undo the host feed's uint8 quantization (q = round(255 * x) of the
    [0, 1]-normalised volume); other inputs pass through untouched."""
    if v.dtype == torch.uint8:
        return v.float() * (1.0 / 255.0)
    return v


def _device_volumes(batch, modalities: Sequence[str], device):
    """The batch's volumes on `device`, dequantized."""
    return {k: dequantize_input(torch.as_tensor(batch[k]).to(device))
            for k in modalities}


def _augmented(vols, modalities: Sequence[str], aug_cfg: AugmentConfig,
               generator):
    """One augmentation draw per sample, shared by its modalities: the
    step's (B, 6) uniforms from `generator`, then `augment_batch` (on the
    card one launch of K13, which reads them there: the step has no host
    sync)."""
    u = draw_uniforms(generator, vols[modalities[0]].shape[0])
    return augment_batch({k: vols[k] for k in modalities}, u, aug_cfg)


def _model_inputs(vols, modalities: Sequence[str], dtype):
    """Cast to the compute dtype and add the channel axis:
    (B, X, Y, Z) -> (B, X, Y, Z, 1)."""
    return [vols[k].to(dtype)[..., None] for k in modalities]


def _prep_inputs(batch, modalities: Sequence[str],
                 aug_cfg: Optional[AugmentConfig], generator, device, dtype):
    """Dequantize, augment (one draw per sample, shared by its modalities),
    cast to the compute dtype and add the channel axis."""
    vols = _device_volumes(batch, modalities, device)
    if aug_cfg is not None:
        vols = _augmented(vols, modalities, aug_cfg, generator)
    return _model_inputs(vols, modalities, dtype)


def _ce_sums(logits, labels, weights=None, mask=None):
    """Cross-entropy as (weighted NLL sum, weight sum), whose ratio is the
    torch-style (weighted) mean; `mask` (B,) zeroes padded samples."""
    nll = cross_entropy(logits, labels, weights, reduce=False)
    if weights is None:
        w = torch.ones(labels.shape[0], dtype=torch.float32,
                       device=logits.device)
    else:
        w = torch.as_tensor(weights, dtype=torch.float32,
                            device=logits.device)[labels.long()]
    if mask is not None:
        nll = nll * mask
        w = w * mask
    return nll.sum(), w.sum()


def _pmean_grads(params, group):
    """Average the parameters' gradients over `group`: one all-reduce of
    the gradients laid end to end, divided by the world size."""
    world = dist.get_world_size(group)

    def pmean(flat):
        dist.all_reduce(flat, group=group)
        flat /= world

    collective_flat([p.grad for p in params if p.grad is not None], pmean)


def make_train_step(modalities: Sequence[str] = ("MRI", "PET"),
                    adversarial: bool = True,
                    aug_cfg: Optional[AugmentConfig] = None,
                    class_weights=None, mask_bn: bool = False, group=None):
    """Returns step(state, batch) -> aux. `batch` maps each modality to a
    (B, X, Y, Z) volume batch (float or uint8), 'label' to (B,) class
    indices and, optionally, 'mask' to (B,) 0/1 weights of real samples.
    The step updates `state` in place and returns detached `loss`,
    `ce_loss`, `ad_loss`, `logits`, `d_mri`, `d_pet` (adversarial),
    `label` and `mask`.

    mask_bn=True feeds the mask into every BatchNorm's batch moments, so a
    duplicate-padded batch trains like its real samples alone.

    group: a torch.distributed process group (the data group): `batch` is
    this rank's rows of the global batch, and the losses, BatchNorm moments
    and gradients are those of the global batch (see the module's
    docstring). `logits`,
    `d_mri`, `d_pet`, `label` and `mask` stay this rank's rows."""
    modalities = tuple(modalities)

    def step(state: TrainState, batch) -> dict:
        with tracing.span("step", state.step):
            return _step(state, batch)

    def _step(state, batch):
        model = state.model
        device = next(model.parameters()).device
        with tracing.span("prep"):
            vols = _device_volumes(batch, modalities, device)
            labels = torch.as_tensor(batch["label"]).to(device).long()
            mask = batch.get("mask")
            if mask is not None:
                mask = torch.as_tensor(mask, dtype=torch.float32).to(device)
        if aug_cfg is not None:
            with tracing.span("augment"):
                vols = _augmented(vols, modalities, aug_cfg, state.generator)
        bn_mask = mask if mask_bn else None

        with tracing.span("forward"), batchnorm.synced(group):
            out = model(*_model_inputs(vols, modalities, state.dtype),
                        train=True, bn_mask=bn_mask, generator=state.generator)
        with tracing.span("loss"):
            logits = out[0] if adversarial else out
            ce_n, ce_d = psum(torch.stack(_ce_sums(logits, labels,
                                                   class_weights, mask)),
                              group)
            ce = ce_n / ce_d
            if adversarial:
                _, d_mri, d_pet = out
                ad = adversarial_loss(d_mri, d_pet, mask, group)
                loss = ce + ad
                aux = {"logits": logits, "d_mri": d_mri, "d_pet": d_pet,
                       "ce_loss": ce, "ad_loss": ad}
            else:
                loss = ce
                aux = {"logits": logits, "ce_loss": loss,
                       "ad_loss": torch.zeros((), device=device)}

        with tracing.span("backward"):
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        with tracing.span("grad_reduce"):
            reduce_partial_grads(model)
            if group is not None:
                _pmean_grads(model.parameters(), group)
        with tracing.span("optimizer"):
            state.optimizer.step()
            state.scheduler.step()
        state.step += 1
        aux = {k: v.detach() for k, v in aux.items()}
        aux["loss"] = loss.detach()
        aux["label"] = labels
        aux["mask"] = (mask if mask is not None
                       else torch.ones(labels.shape[0], device=device))
        return aux

    return step


def make_eval_step(modalities: Sequence[str] = ("MRI", "PET"),
                   adversarial: bool = True, group=None):
    """Returns step(state, metrics, batch) -> (metrics, out): the eval
    forward (train=False) under `torch.inference_mode()` in `state.dtype`,
    its inputs prepared as the train step prepares them without
    augmentation, and the cross-entropy per sample (the reference's val /
    test loss leaves the adversarial term out, reference:
    kfold_train_adversarial.py:157-160). Accuracy, loss and the confusion
    matrix accumulate on the model's device in `metrics` (a `MetricState`);
    the batch may carry a 'mask' (B,) of real samples, so a ragged last
    batch can be padded (`data.pipeline.pad_batch`). `out` holds the
    per-sample `probs` (the positive class's softmax probability, in
    float32), `label` and `mask`, for the exact ROC-AUC at epoch end.

    group: `batch` is this rank's rows of the global batch; the batch's
    MetricState delta is all-reduced over the group, with `batches`
    divided by the world size, so `metrics` counts the global batch on
    every rank. `out` stays this rank's rows."""
    modalities = tuple(modalities)

    @torch.inference_mode()
    def step(state: TrainState, metrics: MetricState, batch):
        model = state.model
        device = next(model.parameters()).device
        inputs = _prep_inputs(batch, modalities, None, None, device,
                              state.dtype)
        out = model(*inputs, train=False)
        logits = out[0] if adversarial else out
        labels = torch.as_tensor(batch["label"]).to(device).long()
        mask = batch.get("mask")
        if mask is not None:
            mask = torch.as_tensor(mask, dtype=torch.float32).to(device)
        nll = cross_entropy(logits, labels, reduce=False)
        probs = torch.softmax(logits.float(), dim=-1)[:, -1]
        metrics = metrics.add(_global_delta(
            MetricState.zero(device).update(logits, labels, nll, mask),
            group))
        if mask is None:
            mask = torch.ones(labels.shape[0], device=device)
        return metrics, {"probs": probs, "label": labels, "mask": mask}

    return step


def _global_delta(delta: MetricState, group) -> MetricState:
    """A batch's MetricState delta summed over `group` (one all-reduce),
    with `batches` divided back to count loader batches, not ranks; the
    delta itself without a group."""
    if group is None:
        return delta
    fields = [getattr(delta, f.name) for f in dataclasses.fields(delta)]
    collective_flat(fields, lambda flat: dist.all_reduce(flat, group=group))
    delta.batches /= dist.get_world_size(group)
    return delta
