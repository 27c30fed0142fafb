"""K-fold experiment driver.

Port of transmf_ad_tpu/train/kfold.py's `run_kfold('adversarial')`, which
reproduces the reference driver topology (reference:
kfold_train_adversarial.py:23-274): task-pinned seeds (ADCN -> 42,
pMCIsMCI -> 996, default 1, --randint True -> random 1..1000), a shuffled
5-fold split of the ADNI index, a further 80/20 train/val split of each
fold's training indices, per-fold training with best-val-accuracy
checkpointing, test evaluation with the best weights, and a final
mean +- std aggregation of [loss, acc, sen, spe, f1, auc].

The splits are sklearn's `KFold(n_splits, shuffle=True, random_state=seed)`
and `train_test_split(test_size=0.2, random_state=seed)`, written in numpy
with the same draws (`np.random.RandomState(seed)`), so that the port needs
no sklearn; a test holds them to sklearn's indices. One RAM-cached
VolumeSource is shared across folds.

The variants 'single', 'advit' and 'mnet' (and `run_holdout`) wait for
their models (ROADMAP.md Queue 1 item 7).
"""

from __future__ import annotations

import math
import os
import random
import warnings
from typing import Dict, List

import numpy as np
import torch

from ..config import Options, str2bool
from ..data.adni import ADNI
from ..data.pipeline import Loader, VolumeSource
from ..utils.logging import Logger
from .trainer import Trainer, TrainerConfig, resolve_dtype

METRIC_NAMES = ("loss", "acc", "sen", "spe", "f1", "auc")


def kfold_split(n: int, n_splits: int, seed: int):
    """sklearn's KFold(n_splits, shuffle=True, random_state=seed).split over
    n samples: the indices shuffled by RandomState(seed), cut into folds
    whose first n % n_splits are one longer; yields (train, test), each in
    ascending order."""
    if not 2 <= n_splits <= n:
        raise ValueError(f"cannot split {n} samples into {n_splits} folds")
    order = np.arange(n)
    np.random.RandomState(seed).shuffle(order)
    sizes = np.full(n_splits, n // n_splits, dtype=int)
    sizes[: n % n_splits] += 1
    start = 0
    for size in sizes:
        test = np.zeros(n, dtype=bool)
        test[order[start:start + size]] = True
        start += size
        yield np.flatnonzero(~test), np.flatnonzero(test)


def train_val_split(indices, seed: int, test_size: float = 0.2):
    """sklearn's train_test_split(indices, test_size=0.2,
    random_state=seed): a RandomState(seed) permutation, the first
    ceil(test_size * n) to the second part, the rest to the first."""
    indices = np.asarray(indices)
    n = len(indices)
    n_test = math.ceil(test_size * n)
    perm = np.random.RandomState(seed).permutation(n)
    return indices[perm[n_test:]], indices[perm[:n_test]]


def transfer_dtype(opt: Options):
    """Host cache / transfer dtype for volumes: the compute dtype when it is
    bfloat16 (`torch.bfloat16`: half the bytes of float32 in RAM, over the
    link and in the device cache), float32 otherwise. `--feed_dtype uint8`
    quantizes the normalized volume instead (1/4 the float32 bytes;
    dequantized on the device — see VolumeSource). Exact-MONAI augmentation
    forces float32 (the exact pipeline is defined on the float32 normalized
    volume, data/exact_monai.py)."""
    if str2bool(opt.aug_exact) and opt.aug_bool:
        return np.float32
    if getattr(opt, "feed_dtype", "auto") not in ("auto", "", None):
        return (torch.bfloat16 if opt.feed_dtype == "bfloat16"
                else np.dtype(opt.feed_dtype))
    dt = resolve_dtype(opt.dtype or "auto", opt.device)
    return torch.bfloat16 if dt == torch.bfloat16 else np.float32


def dataset_weights(records) -> np.ndarray:
    """Inverse-frequency class weights [1/n_neg, 1/n_pos]
    (reference: utils/utils.py:70-82; computed per fold, applied only when
    --use_class_weights True — the reference computes but never applies)."""
    labels = [r["label"] for r in records]
    n0, n1 = max(labels.count(0), 1), max(labels.count(1), 1)
    print(f"negative class has {labels.count(0)} samples")
    print(f"positive class has {labels.count(1)} samples")
    return np.array([1.0 / n0, 1.0 / n1], np.float32)


def task_seed(opt: Options) -> int:
    seed = 1
    if opt.task == "ADCN":
        seed = 42
    elif opt.task == "pMCIsMCI":
        seed = 996
    if opt.randint == "True":
        seed = random.randint(1, 1000)
    return seed


def _variant_spec(variant: str, opt: Options) -> Dict:
    if variant == "adversarial":
        model = {"Transformer": "ad", "CNN": "cnn_ad"}[opt.model]
        return dict(model=model, drop_last=True,
                    optimizer=opt.optimizer, lr=opt.lr, momentum=0.0,
                    milestones=None, epochs=opt.epochs, aug=opt.aug_bool,
                    modalities=("MRI", "PET"))
    if variant in ("single", "advit", "mnet"):
        raise NotImplementedError(
            f"run_kfold variant {variant!r} is not ported yet: its model "
            "waits for ROADMAP.md Queue 1 item 7")
    raise ValueError(f"unknown variant {variant!r}")


def _make_trainer_cfg(opt: Options, spec: Dict, fold_dir: str,
                      seed: int) -> TrainerConfig:
    return TrainerConfig(
        model=spec["model"],
        dim=opt.dim,
        depth=opt.trans_enc_depth,
        heads=opt.heads,
        dropout=opt.dropout,
        optimizer=spec["optimizer"],
        lr=spec["lr"],
        weight_decay=opt.weight_decay,
        momentum=spec["momentum"],
        milestones=spec["milestones"],
        epochs=spec["epochs"],
        aug=spec["aug"],
        aug_exact=str2bool(opt.aug_exact),
        seed=seed,
        save_dir=fold_dir,
        dtype=opt.dtype or "auto",
        resume=opt.resume == "True",
        pretrained_path=opt.pretrained,
        remat=opt.remat == "True",
        debug_nans=opt.debug_nans == "True",
        device=opt.device,
    )


def run_kfold(opt: Options,
              variant: str = "adversarial") -> Dict[str, List[float]]:
    """Train and test every fold (or the `--folds` subset) and aggregate.
    Returns the mean, std and per-fold [loss, acc, sen, spe, f1, auc], the
    seed, and the type name of each fold's train feed."""
    save_dir = os.path.join(opt.checkpoints_dir, opt.name)
    logger_main = Logger(save_dir)
    spec = _variant_spec(variant, opt)

    data = ADNI(opt.dataroot, "ADNI.csv", opt.task).data_dict
    extra: List = []
    if opt.task == "pMCIsMCI" and opt.extra_sample == "True":
        extra = ADNI(opt.dataroot, "ADNI.csv", "ADCN").data_dict

    source = VolumeSource(data + extra, keys=spec["modalities"],
                          dtype=transfer_dtype(opt))
    extra_idx = list(range(len(data), len(data) + len(extra)))

    seed = task_seed(opt)
    print(f"The random seed is {seed}")

    fold_subset = (None if not opt.folds else
                   {int(f) for f in str(opt.folds).split(",") if f != ""})
    results, feeds = [], []
    for fold, (train_idx, test_idx) in enumerate(
            kfold_split(len(data), opt.num_folds, seed)):
        if fold_subset is not None and fold not in fold_subset:
            continue  # same split layout; only the listed folds train
        logger_main.print_message(f"************Fold {fold}************")
        train_idx, val_idx = train_val_split(train_idx, seed)
        train_indices = list(train_idx) + extra_idx
        train_loader = Loader(source, train_indices, opt.batch_size,
                              shuffle=True, drop_last=spec["drop_last"],
                              seed=seed + fold, prefetch=opt.prefetch)
        val_loader = Loader(source, list(val_idx), opt.batch_size)
        test_loader = Loader(source, list(test_idx), opt.batch_size)
        print(f"Train Datasets: {len(train_indices)}")
        print(f"Val Datasets: {len(val_idx)}")
        print(f"Test Datasets: {len(test_idx)}")

        weights = dataset_weights([source.records[i] for i in train_indices])
        class_weights = weights if opt.use_class_weights == "True" else None

        fold_dir = os.path.join(save_dir, str(fold))
        cfg = _make_trainer_cfg(opt, spec, fold_dir, seed)
        trainer = Trainer(cfg, Logger(fold_dir))
        res_fold = trainer.fit(train_loader, val_loader, test_loader,
                               class_weights=class_weights)
        feeds.append(type(trainer.train_feed).__name__)
        logger_main.print_message_nocli(
            f"loss: {res_fold[0]:.4f} accuracy: {res_fold[1]:.4f} "
            f"sensitivity: {res_fold[2]:.4f} specificity: {res_fold[3]:.4f} "
            f"f1 score: {res_fold[4]:.4f} AUC: {res_fold[5]:.4f} "
        )
        results.append(res_fold)

    results = np.array(results, dtype=np.float64)
    # an all-NaN metric column (e.g. f1 on a fold set with no positives)
    # aggregates to NaN silently
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="Mean of empty slice")
        warnings.filterwarnings("ignore",
                                message="Degrees of freedom <= 0")
        res_mean = np.nanmean(results, axis=0)
        res_std = np.nanstd(results, axis=0)
    logger_main.print_message("************Final Results************")
    logger_main.print_message(
        "\n".join(
            f"{name}: {res_mean[i]:.4f} +- {res_std[i]:.4f}"
            for i, name in enumerate(METRIC_NAMES)
        )
    )
    print(f"The random seed is {seed}")
    return {
        "mean": res_mean.tolist(),
        "std": res_std.tolist(),
        "folds": results.tolist(),
        "seed": seed,
        "feeds": feeds,
    }
