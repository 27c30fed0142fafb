"""High-level Trainer: the reference's `train_model` topology as a component.

Port of transmf_ad_tpu/train/trainer.py. It composes the
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

Data parallel (the JAX package's mesh branches): with a process group up
(`parallel.init_distributed`, from `coordinator_address`, `num_processes`
and `process_id`, called before any other CUDA call) every rank runs the
same loop on its rows of each global batch. The state is broadcast from
rank 0 after `init_state` and after every load; the feeds pad each batch
to a multiple of the world size and give each rank its rows (the device
cache row-sharded); the steps all-reduce BatchNorm moments, losses,
gradients and the eval metrics; the epoch's logits, labels and masks are
all-gathered, so the logged metrics, the best epoch and `res_fold` are
the same on every rank. Only rank 0 logs and writes checkpoints (the
others get a `NullLogger`), with a barrier after each write; `latest.pt`
holds every rank's generator, and a resume gives each rank its own.

Tensor parallel (the JAX package's 'model' axis): `model_parallel` = m
splits a world of W ranks into the mesh {'data': W // m, 'model': m}
(`parallel.make_hybrid_mesh`; a world m does not divide raises
`ValueError`, where JAX would leave devices out). The weights JAX's rule
shards are cut into each model rank's rows after `init_state` and after
every load (`parallel.shard_state`), and the sharded layers compute their
rank's channels (`parallel/tensor.py`). The data group takes the place of
the world wherever a batch is split or a sum runs over samples; the ranks
of one model group get the same rows and draw from generators seeded from
their data index, so they draw alike. Checkpoints stay layout-free: every
file holds the whole state_dict (and whole optimizer moments), gathered
over the model group, so a `latest.pt` written at one `model_parallel`
resumes at another with the same data size.

Two switches of the JAX config (`TrainerConfig`): `profile_dir` opens a
`torch.profiler` window (CPU and CUDA activities) at global iteration
`profile_steps[0]` and closes it at `profile_steps[1]`, after a device
sync, writing a Chrome trace into `profile_dir` (rank 0 only) in which the
spans of `utils/tracing.py` (iteration, step and its phases, the encoder
blocks) nest the ops; a window still open when `fit` returns is closed and
written then. `debug_nans`
runs `fit` under `torch.autograd.detect_anomaly(check_nan=True)` and checks
the loss and every gradient after each step: the first NaN or inf raises
`FloatingPointError` naming the iteration. Only this switch syncs each
step; without it the steps stay queued.

The JAX config's `use_pallas` and `data_parallel` fields are not fields
here: a process group is always the mesh.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..data.transforms import AugmentConfig
from ..models import ADVERSARIAL, SINGLE_MODALITY, build_model
from ..parallel import (NullLogger, fetch_global, full_optimizer_state,
                        full_state_dict, init_distributed, is_primary,
                        load_state_dict, make_hybrid_mesh, padded_batch,
                        place_global, process_count, shard_of, shard_state)
from ..serving import resolve_dtype as _resolve_auto
from ..utils import tracing
from ..utils.logging import Logger
from ..utils.torch_import import import_torch_checkpoint
from ..utils.weights import init_weights
from . import checkpoint as ckpt
from .engine import Engine, Events
from .metrics import MetricState, confusion_metrics, roc_auc
from .optim import MILESTONES, multistep_schedule
from .steps import create_state, make_eval_step, make_train_step

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
    # recompute the encoder blocks whose intermediates are worth it in the
    # backward (nn/blocks.py::SNet; activation memory for conv recompute)
    remat: bool = False
    # a torch.profiler window over the global iterations [start, stop):
    # a Chrome trace written into profile_dir (None: no window)
    profile_dir: Optional[str] = None
    profile_steps: tuple = (10, 15)
    # anomaly mode and a finite check of the loss and gradients every step
    debug_nans: bool = False
    # the tensor-parallel 'model' axis: ranks per model group (a divisor
    # of the number of processes; 1 = data parallel alone)
    model_parallel: int = 1
    # data parallel: join a process group before anything else (one
    # trainer process per card; 'auto' = torchrun's environment).
    # save_dir must be storage every rank sees.
    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None

    def __post_init__(self):
        if self.model_parallel < 1:
            raise ValueError(f"TrainerConfig: model_parallel must be at "
                             f"least 1, got {self.model_parallel}")


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
        # before any other CUDA call: it makes this rank's card current
        init_distributed(cfg.coordinator_address, cfg.num_processes,
                         cfg.process_id, device=self.device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.primary = is_primary()
        if not self.primary:
            logger = NullLogger()  # side effects belong to rank 0
        self.logger = logger or Logger(cfg.save_dir)
        self.mesh = None
        n, mp = process_count(), cfg.model_parallel
        if n > 1:
            if n % mp:
                raise ValueError(
                    f"TrainerConfig: model_parallel={mp} does not divide "
                    f"the {n} processes (every process must be on the "
                    "mesh)")
            if mp > 1 and cfg.dim < 1024:
                # the JAX package's soft gate
                self.logger.print_message(
                    f"WARNING: model_parallel={mp} at dim={cfg.dim}: "
                    "tensor parallelism rarely pays below dim 1024 — "
                    "data-parallel only is optimal at reference scale")
            # data axis first: a model group is consecutive ranks
            self.mesh = make_hybrid_mesh({"data": n // mp, "model": mp})
        # the data group, and this rank's place on the data axis
        self.group = self.mesh.data_group if self.mesh else None
        self.world = self.mesh.data if self.mesh else 1
        self.rank = self.mesh.data_index if self.mesh else 0
        self.dtype = resolve_dtype(cfg.dtype, self.device)
        self.model = None  # built by init_state, which sees the volumes
        self.adversarial = cfg.model in ADVERSARIAL
        self.modalities: Tuple[str, ...] = (
            ("MRI",) if cfg.model in SINGLE_MODALITY else ("MRI", "PET"))
        self.state = None
        self.lr_schedule = None
        self._eval_step = None

    # ----- setup -----

    def init_state(self, sample_batch, steps_per_epoch: int):
        """The model, built for `sample_batch`'s volume shape (ADVIT's token
        grid and Mnet's head width follow it, as the JAX package's init
        infers them from its sample inputs), fresh weights from `cfg.seed`
        (`utils/weights.py::init_weights`, drawn on the CPU, so every
        device starts from the same weights), the optimizer and scheduler,
        and the generator of the train step's draws, seeded from
        `cfg.seed + 1` as the JAX package's train key is (and from the
        data index: `rank_seed`). Under a group the state is then placed on
        the mesh: replicated from rank 0, the model axis's weights cut into
        this rank's rows."""
        cfg = self.cfg
        self.model = build_model(
            cfg.model, dim=cfg.dim, depth=cfg.depth, heads=cfg.heads,
            dropout=cfg.dropout, remat=cfg.remat,
            input_shape=tuple(sample_batch[self.modalities[0]].shape[1:4]),
            **(cfg.model_kwargs or {}))
        milestones = (MILESTONES[cfg.optimizer] if cfg.milestones is None
                      else cfg.milestones)
        self.lr_schedule = multistep_schedule(cfg.lr, milestones,
                                              steps_per_epoch)
        init_weights(self.model, torch.Generator().manual_seed(cfg.seed))
        self.state = create_state(
            self.model, self.device, self.dtype,
            seed=rank_seed(cfg.seed + 1, self.rank),
            name=cfg.optimizer, lr=cfg.lr, weight_decay=cfg.weight_decay,
            steps_per_epoch=steps_per_epoch, milestones=milestones,
            momentum=cfg.momentum)
        if cfg.pretrained_path:
            self.load_checkpoint(cfg.pretrained_path)
            self.logger.print_message(
                f"Load pre-training model {cfg.pretrained_path}")
        self.state = shard_state(self.state, self.group, self.mesh)
        return self.state

    def load_checkpoint(self, path: str):
        """Restore model weights and BN running statistics into the live
        state from a `.pt` / `.pth` file (the port's best checkpoint, or a
        reference torch checkpoint, read through
        `utils.torch_import.import_torch_checkpoint`: the keys the JAX
        package's importer reads, shape-checked). Requires `init_state` to
        have run. A flax `.msgpack` raises. Every rank loads; under a
        group the state is then placed on the mesh again."""
        if self.state is None:
            raise RuntimeError("load_checkpoint requires init_state first")
        model = self.state.model
        _load_model(model, import_torch_checkpoint(ckpt.load(path),
                                                   self.cfg.model, model))
        return shard_state(self.state, self.group, self.mesh)

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
        stay tensors. `pad_to` is a multiple of the world size, so the
        batch splits over the ranks."""
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
        """The model's parameters, whole (a sharded one counted over every
        rank of the model axis)."""
        return sum(p.numel() * (s.axis.size if (s := shard_of(p)) else 1)
                   for p in self.state.model.parameters())

    # ----- evaluation -----

    def _eval_epoch(self, loader):
        """One padded / masked pass: MetricState accumulation on the device
        plus per-batch probs / labels, fetched once at the end, for the
        exact ROC-AUC."""
        if self._eval_step is None:
            self._eval_step = make_eval_step(self.modalities,
                                             self.adversarial, self.group)
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
                    pad_to = padded_batch(max(base, b["label"].shape[0]),
                                          self.world)
                dev = self._place(place_global(
                    self._pad_eval_batch(b, pad_to), self.world, self.rank))
            ms, out = eval_step(self.state, ms, dev)
            probs.append(out["probs"])
            labels.append(out["label"])
            masks.append(out["mask"])
        # every rank's rows, batch by batch, in the global order
        parts = len(probs)
        probs = fetch_global(torch.cat(probs), parts, self.group)
        labels = fetch_global(torch.cat(labels), parts, self.group)
        valid = fetch_global(torch.cat(masks), parts, self.group) > 0
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
        streaming DeviceFeed. Under a group the batch is padded to a
        multiple of the world size, the device cache is row-sharded
        (`cache_bytes` counts a rank's rows) and the hybrid tier is not
        used, as in the JAX package. Returns (train feed, val feed)."""
        from ..data.device_cache import (DeviceCachedFeed, HybridCachedFeed,
                                         cache_bytes, hbm_budget)
        from ..data.pipeline import DeviceFeed

        cfg, logger = self.cfg, self.logger
        pad_to = padded_batch(getattr(train_loader, "batch_size", None)
                              or sample["label"].shape[0], self.world)
        feed = train_loader
        val_feed = val_loader
        already_fed = (isinstance(train_loader, DeviceFeed)
                       or getattr(train_loader, "device_resident", False))
        if not already_fed and not exact_aug \
                and cfg.device_cache in ("auto", "on", "hybrid") \
                and hasattr(train_loader, "source"):
            budget = hbm_budget(self.device)
            tb = cache_bytes(train_loader, self.world)
            if tb <= budget and cfg.device_cache != "hybrid":
                feed = DeviceCachedFeed(train_loader, self.device,
                                        pad_to=pad_to, group=self.group)
                vb = (cache_bytes(val_loader, self.world)
                      if hasattr(val_loader, "source") else budget)
                if tb + vb <= budget:
                    val_feed = DeviceCachedFeed(val_loader, self.device,
                                                group=self.group)
                logger.print_message(
                    f"HBM dataset cache: train {tb / 2**20:.0f} MB/device"
                    + ("" if val_feed is val_loader
                       else f" + val {vb / 2**20:.0f} MB/device")
                    + f" (budget {budget / 2**20:.0f} MB)")
            elif self.mesh is None \
                    and cfg.device_cache in ("auto", "hybrid"):
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
                              pad_to=pad_to, group=self.group)
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
        step_kw = dict(aug_cfg=aug_cfg, class_weights=class_weights,
                       group=self.group)
        train_step = make_train_step(
            self.modalities, self.adversarial,
            mask_bn=(cfg.mask_bn is True), **step_kw)
        # only a ragged batch takes the masked step
        train_step_masked = (
            make_train_step(self.modalities, self.adversarial,
                            mask_bn=True, **step_kw)
            if cfg.mask_bn == "ragged" else train_step)
        self._eval_step = make_eval_step(self.modalities, self.adversarial,
                                         self.group)
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
                if not _restore_state(self.state, restored, self.rank,
                                      self.world):
                    logger.print_message(
                        "WARNING: latest checkpoint holds no generator state "
                        f"for {self.world} data ranks; the ranks keep fresh "
                        "generators")
                self.state = shard_state(self.state, self.group, self.mesh)
                start_epoch = int(restored["epoch"])
                logger.print_message(f"Resumed from epoch {start_epoch}")

        window = _ProfileWindow(cfg, self.device, self.primary)

        def step_fn(engine, batch):
            it = engine.state.iteration
            window.at(it)
            # host-side real-sample count the feeds attach (of the global
            # batch: this rank holds 1 / world of it); a short final batch
            # routes to the mask-weighted-BN step
            n_real = batch.pop("_n_real", None)
            ragged = (n_real is not None
                      and n_real < batch["label"].shape[0] * self.world)
            step = train_step_masked if ragged else train_step
            with tracing.span("iteration", it):
                if cfg.debug_nans:
                    aux = _checked_step(step, self.state, batch, it)
                else:
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
            got = _fetch(outs, self.adversarial, self.group)
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
            # the val metrics, and so the best epoch, are the same on every
            # rank; rank 0 writes, the others track the same decision, and
            # the barrier keeps them from reading a file before it lands.
            # Sharded weights are gathered by every rank of a model group.
            sharded = self.mesh is not None and self.mesh.axis is not None
            if self.primary or sharded:
                best = _saveable(self.state)
            if self.primary:
                checkpointer.maybe_save(best, metrics["accuracy"],
                                        engine.state.epoch)
            else:
                checkpointer.track(metrics["accuracy"], engine.state.epoch)
            if cfg.save_latest_every and (
                engine.state.epoch % cfg.save_latest_every == 0
            ):
                latest = _saveable(self.state, full=True)
                if self.mesh is not None:  # every rank's generator
                    latest["generators"] = [None] * process_count()
                    dist.all_gather_object(latest["generators"],
                                           latest["generator"])
                    latest["model_parallel"] = self.mesh.model
                if self.primary:
                    ckpt.save_latest(cfg.save_dir, {
                        **latest, "epoch": engine.state.epoch})
            if self.mesh is not None:
                dist.barrier()

        anomaly = (torch.autograd.detect_anomaly(check_nan=True)
                   if cfg.debug_nans else contextlib.nullcontext())
        try:
            with anomaly:
                trainer.run(feed, cfg.epochs, start_epoch=start_epoch)
        finally:
            window.close()  # a window the run did not reach the end of

        res_fold = None
        if test_loader is not None:
            best = checkpointer.best_path()
            if best is not None:
                self.load_checkpoint(best)
                logger.print_message(f"Load best model {best}")
            metrics = self.evaluate(test_loader)
            logger.print_message("*" * 62)
            logger.print_message("Test Results")
            logger.print_message(_fmt_metrics(metrics))
            res_fold = [metrics["loss"], metrics["accuracy"], metrics["sen"],
                        metrics["spe"], metrics["f1"], metrics["auc"]]
        return res_fold


class _ProfileWindow:
    """`TrainerConfig.profile_dir`'s window: a `torch.profiler.profile`
    (CPU, and CUDA on a card) from global iteration `profile_steps[0]` up
    to `profile_steps[1]`, with the port's tracer on (`utils/tracing.py`),
    so each iteration is a record_function range "iteration <n>" around the
    step's spans; on closing, after a device sync, the tracer goes off and
    forgets its spans, and a Chrome trace `trace_<start>_<stop>.json` is
    written into `profile_dir`. Only the primary rank profiles; without
    `profile_dir` every method returns at once."""

    def __init__(self, cfg, device: torch.device, primary: bool):
        self.dir = cfg.profile_dir if primary else None
        self.start, self.stop = cfg.profile_steps
        self.device = device
        self.prof = None

    def at(self, iteration: int):
        if self.dir is None:
            return
        if iteration == self.start and self.prof is None:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.start()
            tracing.enable()
        elif iteration == self.stop:
            self.close()

    def close(self):
        """Sync the device, stop the window and write its trace."""
        if self.prof is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        tracing.disable()
        tracing.drain()  # the trace holds the spans as ranges
        self.prof.stop()
        os.makedirs(self.dir, exist_ok=True)
        self.prof.export_chrome_trace(os.path.join(
            self.dir, f"trace_{self.start}_{self.stop}.json"))
        self.prof = None


def _checked_step(step, state, batch, iteration: int) -> dict:
    """`debug_nans`: run the step (anomaly mode is on: a NaN in the
    backward raises there), then check the loss and every gradient at one
    sync; the first NaN or inf raises `FloatingPointError`."""
    try:
        aux = step(state, batch)
    except RuntimeError as e:
        if "returned nan values" not in str(e):
            raise
        raise FloatingPointError(
            f"debug_nans: iteration {iteration}: {e}") from e
    named = [("loss", aux["loss"])] + [
        (n, p.grad) for n, p in state.model.named_parameters()
        if p.grad is not None]
    finite = torch.stack([torch.isfinite(t).all() for _, t in named]).cpu()
    if not bool(finite.all()):
        bad = named[int((~finite).nonzero()[0, 0])][0]
        raise FloatingPointError(
            f"debug_nans: iteration {iteration}: non-finite {bad}")
    return aux


def rank_seed(seed: int, rank: int) -> int:
    """The seed of the generator of data index `rank`: `seed` itself on
    data index 0 (the single-process draws), another stream on every
    other, as the JAX package folds the data axis's index into its key
    (and replicates it over 'model')."""
    return seed + (rank << 32)


def _fetch(outs, adversarial: bool, group=None) -> dict:
    """The train steps' outputs of one epoch as numpy arrays, stacked on
    the device and copied to the host once per key; the per-sample keys
    gathered from every rank in the global order (the losses are global
    already)."""
    keys = ["ce_loss", "ad_loss", "logits", "label", "mask"]
    if adversarial:
        keys += ["d_mri", "d_pet"]
    out = {}
    for k in keys:
        vals = [o[k] for o in outs]
        if vals[0].ndim == 0:
            out[k] = torch.stack(vals).float().cpu().numpy()
        else:
            out[k] = fetch_global(torch.cat(vals), len(vals), group)
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
    """Load a whole state_dict by the reference's names into `model`,
    strictly (every parameter and running statistic, nothing else; a
    reference file goes through `import_torch_checkpoint` first); a
    sharded parameter takes this rank's rows."""
    load_state_dict(model, sd)


def _saveable(state, full: bool = False):
    """The model's whole state_dict (CPU copies; sharded parameters
    gathered over the model group, a collective there); with `full`, also
    the optimizer (its moments whole), the scheduler, the step count and
    the generator's state."""
    out = {k: v.detach().cpu().clone()
           for k, v in full_state_dict(state.model).items()}
    if not full:
        return out
    return {"model": out, "optimizer": full_optimizer_state(state.optimizer),
            "scheduler": state.scheduler.state_dict(), "step": state.step,
            "generator": state.generator.get_state()}


def _restore_state(state, restored, rank: int = 0, world: int = 1) -> bool:
    """Put a `latest.pt` dict (or a bare state_dict) back into `state`;
    data index `rank` of `world` takes the generator of its data index
    from 'generators' (every rank's, in rank order, of a run whose model
    groups had 'model_parallel' ranks; a single-process file's
    'generator' is data index 0's). Returns False when a full-state file
    holds no generator for this data size (the generator is then left as
    it is). Whole moments of sharded parameters are cut by `shard_state`
    after it."""
    _load_model(state.model, restored.get("model", restored))
    if "optimizer" in restored:
        state.optimizer.load_state_dict(restored["optimizer"])
        state.scheduler.load_state_dict(restored["scheduler"])
    if "step" in restored:
        state.step = int(restored["step"])
    gens = restored.get("generators")
    mp = int(restored.get("model_parallel", 1))
    if gens is None and "generator" in restored:
        gens, mp = [restored["generator"]], 1
    if gens is None or len(gens) != world * mp:
        return "model" not in restored
    state.generator.set_state(gens[rank * mp])
    return True
