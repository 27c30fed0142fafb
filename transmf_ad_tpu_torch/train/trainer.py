"""High-level Trainer: the reference's `train_model` topology as a component.

Port of transmf_ad_tpu/train/trainer.py for one device. It composes the
train and eval steps, the event engine, the metric accumulators, the LR
schedule, best-checkpoint retention and the test evaluation as the
reference driver does with ignite (reference:
kfold_train_adversarial.py:89-254): per-epoch train metrics (accuracy,
discriminator accuracies, mean ce / ad loss), per-epoch validation
(loss / acc / sen / spe / f1 / AUC) with best-by-accuracy checkpointing,
and a final test pass with the best weights restored. Returns the
reference's res_fold = [loss, acc, sen, spe, f1, auc].

The steps' outputs stay on the device during the epoch and are fetched once
at its end: that fetch is the epoch's only synchronization, so the launches
of one step queue behind the last while the host prepares the next. A
`latest.pt` full-state checkpoint enables crash-resume (absent upstream).

Not ported yet: the data-parallel mesh and the multi-host runtime, remat,
the profiler trace and the NaN debugging switch (ROADMAP.md Queue 1 items 8
and 9). A config that asks for one of them raises: `remat` and `debug_nans`,
which the CLI's flags reach, on a true value; the other fields of the JAX
package's config are not fields here.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.transforms import AugmentConfig
from ..models import ADVERSARIAL, build_model
from ..serving import resolve_dtype as _resolve_auto
from ..utils.logging import Logger
from ..utils.weights import init_weights
from . import checkpoint as ckpt
from .engine import Engine, Events
from .metrics import MetricState, confusion_metrics, roc_auc
from .optim import MILESTONES, multistep_schedule
from .steps import create_state, make_eval_step, make_train_step

# flags of the JAX package's TrainerConfig that the CLI reaches and this
# port does not carry out yet; a config that sets one raises
UNPORTED = ("remat", "debug_nans")


@dataclass
class TrainerConfig:
    model: str = "ad"
    dim: int = 128
    depth: int = 3
    heads: int = 4
    dropout: float = 0.0
    optimizer: str = "Adam"
    lr: float = 1e-4
    weight_decay: float = 0.0
    momentum: float = 0.0
    milestones: Optional[Sequence[int]] = None  # None = reference defaults
    epochs: int = 40
    aug: bool = True
    aug_cfg: AugmentConfig = field(default_factory=AugmentConfig)
    seed: int = 42
    save_dir: str = "./checkpoints/run"
    model_kwargs: Optional[dict] = None  # extra arch params for build_model
    dtype: Any = "auto"  # 'auto': bfloat16 on CUDA, float32 on the CPU
    resume: bool = False
    save_latest_every: int = 0  # epochs between resume checkpoints; 0 = off
    # device-resident dataset cache: 'auto' caches train+val volumes on
    # the device when they fit the budget (data/device_cache.py), else
    # keeps as many train rows resident as fit ('hybrid' tier) or streams;
    # 'off' always streams; 'on' raises if the dataset exceeds the budget;
    # 'hybrid' forces the hot/cold tier.
    device_cache: str = "auto"
    pretrained_path: str = ""  # load weights before training
    # BN batch moments on duplicate-padded ragged batches (see pad_batch):
    # 'ragged' (default) routes only short final batches through the
    # mask-weighted-BN step; True masks every step; False never masks.
    mask_bn: Any = "ragged"
    # exact-MONAI augmentation (data/exact_monai.py): host-side per-sample
    # transforms instead of the device resample. Implies a float32 feed and
    # streams the train feed (host batches change every epoch).
    aug_exact: bool = False
    progress: bool = True  # per-iteration progress bar (ignite parity)
    device: str = "cuda"  # 'cuda' or 'cpu'
    remat: bool = False  # not ported yet (ROADMAP.md Queue 1 item 8)
    debug_nans: bool = False  # not ported

    def __post_init__(self):
        bad = [k for k in UNPORTED if getattr(self, k)]
        if bad:
            raise NotImplementedError(
                f"TrainerConfig: {bad} not ported yet (remat: ROADMAP.md "
                "Queue 1 item 8; NaN debugging has no port)")


def resolve_dtype(dtype, device) -> torch.dtype:
    """A TrainerConfig.dtype spec -> the compute dtype on `device`.

    'auto' -> bfloat16 on CUDA, float32 elsewhere; 'float32' / 'f32' ->
    float32; any other name is a torch dtype's ('bfloat16', 'float16');
    a torch.dtype is taken as it is."""
    if isinstance(dtype, str):
        if dtype == "auto":
            return _resolve_auto("auto", torch.device(device))
        if dtype in ("float32", "f32"):
            return torch.float32
        dt = getattr(torch, dtype, None)
        if not isinstance(dt, torch.dtype):
            raise ValueError(f"unknown dtype {dtype!r}")
        return dt
    return dtype


class Trainer:
    def __init__(self, cfg: TrainerConfig, logger: Optional[Logger] = None):
        self.cfg = cfg
        self.device = torch.device(cfg.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("TrainerConfig.device is 'cuda' but no CUDA "
                               "device is available; pass device='cpu' to "
                               "train on the CPU")
        self.logger = logger or Logger(cfg.save_dir)
        self.dtype = resolve_dtype(cfg.dtype, self.device)
        self.model = build_model(
            cfg.model, dim=cfg.dim, depth=cfg.depth, heads=cfg.heads,
            dropout=cfg.dropout, **(cfg.model_kwargs or {}))
        self.adversarial = cfg.model in ADVERSARIAL
        self.modalities: Tuple[str, ...] = ("MRI", "PET")
        self.state = None
        self.lr_schedule = None
        self._eval_step = None

    # ----- setup -----

    def init_state(self, sample_batch, steps_per_epoch: int):
        """Fresh weights from `cfg.seed` (`utils/weights.py::init_weights`,
        drawn on the CPU, so every device starts from the same weights),
        the optimizer and scheduler, and the generator of the train step's
        draws, seeded from `cfg.seed + 1` as the JAX package's train key
        is. `sample_batch` is unused: torch modules know their shapes."""
        cfg = self.cfg
        milestones = (MILESTONES[cfg.optimizer] if cfg.milestones is None
                      else cfg.milestones)
        self.lr_schedule = multistep_schedule(cfg.lr, milestones,
                                              steps_per_epoch)
        init_weights(self.model, torch.Generator().manual_seed(cfg.seed))
        self.state = create_state(
            self.model, self.device, self.dtype, seed=cfg.seed + 1,
            name=cfg.optimizer, lr=cfg.lr, weight_decay=cfg.weight_decay,
            steps_per_epoch=steps_per_epoch, milestones=milestones,
            momentum=cfg.momentum)
        if cfg.pretrained_path:
            self.load_checkpoint(cfg.pretrained_path)
            self.logger.print_message(
                f"Load pre-training model {cfg.pretrained_path}")
        return self.state

    def load_checkpoint(self, path: str):
        """Restore model weights and BN running statistics into the live
        state from a `.pt` / `.pth` file (the port's best checkpoint, or a
        reference torch checkpoint under the same names). Requires
        `init_state` to have run. A flax `.msgpack` raises."""
        if self.state is None:
            raise RuntimeError("load_checkpoint requires init_state first")
        _load_model(self.state.model, ckpt.load(path))
        return self.state

    def evaluate_from_checkpoint(self, loader, checkpoint_path: str) -> dict:
        """Public one-call scoring entry: initialize (if needed), restore
        `checkpoint_path` and run the full test-metric pass over `loader`
        (reference: kfold_train_adversarial.py:229-250)."""
        if self.state is None:
            sample = (loader.peek() if hasattr(loader, "peek")
                      else next(iter(loader)))
            self.init_state(sample, steps_per_epoch=1)
        self.load_checkpoint(checkpoint_path)
        return self.evaluate(loader)

    def _pad_eval_batch(self, batch, pad_to: int):
        """Pad the batch to a fixed leading size with ZEROS (not
        `pad_batch`'s wrap-around duplicates, as in the JAX package) and
        attach a validity mask; numpy arrays stay numpy arrays and tensors
        stay tensors."""
        n = batch["label"].shape[0]
        out = {}
        for k in (*self.modalities, "label"):
            v = batch[k]
            if not isinstance(v, torch.Tensor):
                v = np.asarray(v)
            if n < pad_to:
                shape = (pad_to - n, *v.shape[1:])
                if isinstance(v, torch.Tensor):
                    v = torch.cat([v, torch.zeros(shape, dtype=v.dtype)])
                else:
                    v = np.concatenate([v, np.zeros(shape, v.dtype)])
            out[k] = v
        mask = np.zeros(pad_to, np.float32)
        mask[:n] = 1.0
        out["mask"] = mask
        return out

    def _place(self, batch):
        """Host -> device, synchronously (the eval loaders that are not
        cached)."""
        return {k: (v if isinstance(v, torch.Tensor)
                    else torch.from_numpy(np.ascontiguousarray(v)))
                .to(self.device) for k, v in batch.items()}

    def param_count(self) -> int:
        return sum(p.numel() for p in self.state.model.parameters())

    # ----- evaluation -----

    def _eval_epoch(self, loader):
        """One padded / masked pass: MetricState accumulation on the device
        plus per-batch probs / labels, fetched once at the end, for the
        exact ROC-AUC."""
        if self._eval_step is None:
            self._eval_step = make_eval_step(self.modalities,
                                             self.adversarial)
        eval_step = self._eval_step
        pad_to = None
        ms = MetricState.zero(self.device)
        probs, labels, masks = [], [], []
        from ..utils.progress import iter_progress

        it = iter_progress(loader, total=len(loader) if hasattr(
            loader, "__len__") else None, label="Evaluating",
            enabled=self.cfg.progress)
        device_resident = getattr(loader, "device_resident", False)
        for b in it:
            b.pop("_n_real", None)  # host metadata (train-only dispatch)
            if device_resident:
                dev = b  # already padded and masked by the device cache
            else:
                if pad_to is None:
                    base = (getattr(loader, "batch_size", None)
                            or b["label"].shape[0])
                    pad_to = max(base, b["label"].shape[0])
                dev = self._place(self._pad_eval_batch(b, pad_to))
            ms, out = eval_step(self.state, ms, dev)
            probs.append(out["probs"])
            labels.append(out["label"])
            masks.append(out["mask"])
        probs = torch.cat(probs).float().cpu().numpy()
        labels = torch.cat(labels).cpu().numpy()
        valid = torch.cat(masks).cpu().numpy() > 0
        return ms, probs[valid], labels[valid]

    def evaluate(self, loader) -> dict:
        ms, probs, labels = self._eval_epoch(loader)
        conf = ms.confusion.cpu().numpy()
        total = float(ms.total)
        m = confusion_metrics(conf)
        return {
            "loss": float(ms.loss_sum) / total,
            "accuracy": float(ms.correct) / total,
            "auc": roc_auc(probs, labels),
            "confusion": conf,
            **m,
        }

    def predict(self, loader):
        """Inference: positive-class probabilities + labels over a loader."""
        _, probs, labels = self._eval_epoch(loader)
        return probs, labels

    # ----- training -----

    def _train_feeds(self, train_loader, val_loader, sample, exact_aug):
        """The feed selection of the JAX package's `fit`: the device cache
        when the train set fits the budget (and val too, when both fit),
        else the hybrid tier when at least two batches' rows fit, else the
        streaming DeviceFeed. Returns (train feed, val feed)."""
        from ..data.device_cache import (DeviceCachedFeed, HybridCachedFeed,
                                         cache_bytes, hbm_budget)
        from ..data.pipeline import DeviceFeed

        cfg, logger = self.cfg, self.logger
        pad_to = (getattr(train_loader, "batch_size", None)
                  or sample["label"].shape[0])
        feed = train_loader
        val_feed = val_loader
        already_fed = (isinstance(train_loader, DeviceFeed)
                       or getattr(train_loader, "device_resident", False))
        if not already_fed and not exact_aug \
                and cfg.device_cache in ("auto", "on", "hybrid") \
                and hasattr(train_loader, "source"):
            budget = hbm_budget(self.device)
            tb = cache_bytes(train_loader)
            if tb <= budget and cfg.device_cache != "hybrid":
                feed = DeviceCachedFeed(train_loader, self.device,
                                        pad_to=pad_to)
                vb = (cache_bytes(val_loader)
                      if hasattr(val_loader, "source") else budget)
                if tb + vb <= budget:
                    val_feed = DeviceCachedFeed(val_loader, self.device)
                logger.print_message(
                    f"HBM dataset cache: train {tb / 2**20:.0f} MB/device"
                    + ("" if val_feed is val_loader
                       else f" + val {vb / 2**20:.0f} MB/device")
                    + f" (budget {budget / 2**20:.0f} MB)")
            elif cfg.device_cache in ("auto", "hybrid"):
                # over-budget (or forced): hot fraction on the device, cold
                # rows streamed; the transfer shrinks by the hot fraction
                hybrid = HybridCachedFeed(train_loader, self.device,
                                          pad_to=pad_to, budget=budget)
                if hybrid.n_hot >= 2 * pad_to \
                        or cfg.device_cache == "hybrid":
                    feed = hybrid
                    logger.print_message(
                        f"HBM hybrid cache: {hybrid.n_hot}/"
                        f"{len(train_loader.indices)} train volumes hot "
                        f"({100 * hybrid.hot_fraction:.0f}%; "
                        f"budget {budget / 2**20:.0f} MB, full set needs "
                        f"{tb / 2**20:.0f} MB)")
            elif cfg.device_cache == "on":
                raise ValueError(
                    f"device_cache='on' but the training set needs "
                    f"{tb / 2**20:.0f} MB/device > budget "
                    f"{budget / 2**20:.0f} MB (set TRANSMF_CACHE_BUDGET_MB "
                    f"or use device_cache='auto' to stream)")
        elif cfg.device_cache == "on" \
                and not getattr(train_loader, "device_resident", False):
            why = ("aug_exact host transforms change batches every epoch"
                   if exact_aug else
                   "the loader exposes no .source to cache (pre-wrapped "
                   "feed?)")
            raise ValueError(
                f"device_cache='on' but the train feed cannot be cached: "
                f"{why}; use device_cache='auto' to stream")
        if feed is train_loader and not isinstance(train_loader, DeviceFeed):
            feed = DeviceFeed(train_loader, self.device, depth=2,
                              pad_to=pad_to)
        return feed, val_feed

    def fit(self, train_loader, val_loader, test_loader=None,
            class_weights=None):
        cfg = self.cfg
        logger = self.logger
        steps_per_epoch = max(1, len(train_loader))
        sample = (train_loader.peek() if hasattr(train_loader, "peek")
                  else next(iter(train_loader)))
        if self.state is None:
            self.init_state(sample, steps_per_epoch)

        exact_aug = cfg.aug and cfg.aug_exact
        aug_cfg = cfg.aug_cfg if (cfg.aug and not exact_aug) else None
        if exact_aug:
            _missing = object()
            st = getattr(train_loader, "sample_transform", _missing)
            if st is _missing:
                # a loader with no hook would otherwise train with NO
                # augmentation despite --aug_exact True
                raise ValueError(
                    "aug_exact=True but the train loader has no "
                    "sample_transform hook (use data.pipeline.Loader, or "
                    "apply data.exact_monai.make_sample_transform yourself)")
            if st is None:
                from ..data.exact_monai import make_sample_transform

                st = make_sample_transform(cfg.seed + 7, cfg.aug_cfg)
                if self.dtype != torch.float32:
                    # cast after the exact float32 transform: half the
                    # bytes over the link in bfloat16
                    st = _cast_after_transform(st, self.modalities,
                                               self.dtype)
                train_loader.sample_transform = st
        step_kw = dict(aug_cfg=aug_cfg, class_weights=class_weights)
        train_step = make_train_step(
            self.modalities, self.adversarial,
            mask_bn=(cfg.mask_bn is True), **step_kw)
        # only a ragged batch takes the masked step
        train_step_masked = (
            make_train_step(self.modalities, self.adversarial,
                            mask_bn=True, **step_kw)
            if cfg.mask_bn == "ragged" else train_step)
        self._eval_step = make_eval_step(self.modalities, self.adversarial)
        feed, val_feed = self._train_feeds(train_loader, val_loader, sample,
                                           exact_aug)
        self.train_feed, self.val_feed = feed, val_feed

        checkpointer = ckpt.BestCheckpointer(cfg.save_dir)
        epoch_outputs = []
        start_epoch = 0

        if cfg.resume:
            restored = ckpt.load_latest(cfg.save_dir)
            if restored is not None:
                if "optimizer" not in restored:
                    logger.print_message(
                        "WARNING: latest checkpoint has no optimizer state; "
                        "resuming weights only (Adam moments and LR-schedule "
                        "position reset)")
                _restore_state(self.state, restored)
                start_epoch = int(restored["epoch"])
                logger.print_message(f"Resumed from epoch {start_epoch}")

        def step_fn(engine, batch):
            # host-side real-sample count the feeds attach; a short final
            # batch routes to the mask-weighted-BN step
            n_real = batch.pop("_n_real", None)
            ragged = (n_real is not None
                      and n_real < batch["label"].shape[0])
            step = train_step_masked if ragged else train_step
            aux = step(self.state, batch)
            epoch_outputs.append(aux)  # device tensors; not synced here
            return aux

        trainer = Engine(step_fn)

        if cfg.progress:
            # per-iteration progress (ignite ProgressBar parity,
            # reference: kfold_train_adversarial.py:139); counts launches
            # and never synchronizes with the device mid-epoch
            from ..utils.progress import ProgressBar

            ProgressBar(persist=True).attach(
                trainer, total=max(1, len(train_loader)))

        @trainer.on(Events.EPOCH_COMPLETED)
        def log_train(engine):
            outs = list(epoch_outputs)
            epoch_outputs.clear()
            if not outs:  # drop_last can empty a tiny fold's epoch
                logger.print_message(
                    f"Training Results - Epoch[{engine.state.epoch}] "
                    "(no full batches)")
                return
            # the epoch's one synchronization: every step's outputs at once
            got = _fetch(outs, self.adversarial)
            ce = float(np.mean(got["ce_loss"]))
            ad = float(np.mean(got["ad_loss"]))
            valid = got["mask"] > 0  # drop padded duplicates from metrics
            logits, labels = got["logits"][valid], got["label"][valid]
            acc = float((logits.argmax(-1) == labels).mean())
            lr = float(np.float32(self.lr_schedule(self.state.step - 1)))
            n_samples = labels.shape[0]
            epoch_time = time.perf_counter() - engine.state.epoch_t0
            engine.state.epoch_time = epoch_time
            vps = n_samples / epoch_time if epoch_time else 0
            logger.print_message("-------------------------------------------------")
            logger.print_message(f"Current learning rate: {lr}")
            logger.print_message(
                f"Epoch time: {epoch_time:.2f}s "
                f"({vps:.2f} volumes/s)"
            )
            logger.print_message(f"Training Results - Epoch[{engine.state.epoch}] ")
            msg = f"ce_loss: {ce:.4f} ad_loss: {ad:.4f} accuracy: {acc:.4f} "
            if self.adversarial:
                d_mri, d_pet = got["d_mri"][valid], got["d_pet"][valid]
                mri_acc = float((d_mri.argmax(-1) == 1).mean())
                pet_acc = float((d_pet.argmax(-1) == 0).mean())
                msg += f"MRIaccuracy: {mri_acc:.4f} PETaccuracy: {pet_acc:.4f} "
            engine.state.metrics["train_accuracy"] = acc
            logger.print_message(msg)

        @trainer.on(Events.EPOCH_COMPLETED)
        def validate(engine):
            metrics = self.evaluate(val_feed)
            logger.print_message(
                f"Validation Results - Epoch[{engine.state.epoch}] "
            )
            logger.print_message(_fmt_metrics(metrics))
            engine.state.metrics["val"] = metrics
            checkpointer.maybe_save(
                _saveable(self.state), metrics["accuracy"],
                engine.state.epoch)
            if cfg.save_latest_every and (
                engine.state.epoch % cfg.save_latest_every == 0
            ):
                ckpt.save_latest(cfg.save_dir, {
                    **_saveable(self.state, full=True),
                    "epoch": engine.state.epoch,
                })

        trainer.run(feed, cfg.epochs, start_epoch=start_epoch)

        res_fold = None
        if test_loader is not None:
            best = checkpointer.best_path()
            if best is not None:
                _load_model(self.state.model, ckpt.load(best))
                logger.print_message(f"Load best model {best}")
            metrics = self.evaluate(test_loader)
            logger.print_message("*" * 62)
            logger.print_message("Test Results")
            logger.print_message(_fmt_metrics(metrics))
            res_fold = [metrics["loss"], metrics["accuracy"], metrics["sen"],
                        metrics["spe"], metrics["f1"], metrics["auc"]]
        return res_fold


def _fetch(outs, adversarial: bool) -> dict:
    """The train steps' outputs of one epoch as numpy arrays, stacked on
    the device and copied to the host once per key."""
    keys = ["ce_loss", "ad_loss", "logits", "label", "mask"]
    if adversarial:
        keys += ["d_mri", "d_pet"]
    out = {}
    for k in keys:
        vals = [o[k] for o in outs]
        joined = torch.stack(vals) if vals[0].ndim == 0 else torch.cat(vals)
        out[k] = joined.float().cpu().numpy() if joined.is_floating_point() \
            else joined.cpu().numpy()
    return out


def _cast_after_transform(st, modalities, dtype):
    """Wrap a host sample_transform to cast volume keys to the compute
    dtype after the exact float32 transform: a bfloat16 CPU tensor for
    bfloat16 (numpy has none), a numpy array otherwise."""

    def wrapped(item):
        out = dict(st(item))
        for k in modalities:
            v = torch.from_numpy(np.ascontiguousarray(out[k], np.float32))
            out[k] = (v.to(dtype) if dtype == torch.bfloat16
                      else v.to(dtype).numpy())
        return out

    return wrapped


def _fmt_metrics(m: dict) -> str:
    return (
        f"loss: {m['loss']:.4f} accuracy: {m['accuracy']:.4f} "
        f"sensitivity: {m['sen']:.4f} specificity: {m['spe']:.4f} "
        f"f1 score: {m['f1']:.4f} AUC: {m['auc']:.4f} "
    )


def _load_model(model, sd):
    """Load a state_dict by the reference's names into `model`: every
    parameter and running statistic must be there; a reference file's
    BatchNorm `num_batches_tracked` counters are the only extra keys
    allowed."""
    res = model.load_state_dict(sd, strict=False)
    extra = [k for k in res.unexpected_keys
             if not k.endswith("num_batches_tracked")]
    if res.missing_keys or extra:
        raise RuntimeError(f"checkpoint does not match the model: missing "
                           f"{res.missing_keys}, unexpected {extra}")


def _saveable(state, full: bool = False):
    """The model's state_dict (CPU copies); with `full`, also the
    optimizer, the scheduler, the step count and the generator's state."""
    out = {k: v.detach().cpu().clone()
           for k, v in state.model.state_dict().items()}
    if not full:
        return out
    return {"model": out, "optimizer": state.optimizer.state_dict(),
            "scheduler": state.scheduler.state_dict(), "step": state.step,
            "generator": state.generator.get_state()}


def _restore_state(state, restored):
    """Put a `latest.pt` dict (or a bare state_dict) back into `state`."""
    _load_model(state.model, restored.get("model", restored))
    if "optimizer" in restored:
        state.optimizer.load_state_dict(restored["optimizer"])
        state.scheduler.load_state_dict(restored["scheduler"])
    if "step" in restored:
        state.step = int(restored["step"])
    if "generator" in restored:
        state.generator.set_state(restored["generator"])
