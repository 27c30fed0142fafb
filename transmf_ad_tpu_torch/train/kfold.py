"""K-fold and hold-out experiment drivers.

Port of transmf_ad_tpu/train/kfold.py, which reproduces the reference
driver topology (reference: kfold_train_adversarial.py:23-274 and
siblings): task-pinned seeds (ADCN -> 42, pMCIsMCI -> 996, default 1,
--randint True -> random 1..1000), a shuffled 5-fold split of the ADNI
index, a further 80/20 train/val split of each fold's training indices,
per-fold training with best-val-accuracy checkpointing, test evaluation
with the best weights, and a final mean +- std aggregation of [loss, acc,
sen, spe, f1, auc].

Driver variants (one per reference entry point):
 - 'adversarial': ModelAd / ModelCNNAd, triple loss, drop_last train
   loader                      (reference: kfold_train_adversarial.py)
 - 'single':      ModelSingle, MRI only, no drop_last, so the last train
   batch may be ragged and take the masked step
                               (reference: kfold_train_single.py:64,74-76)
 - 'advit':       ADVIT, volumes padded to (128, 128, 79), Adam 1e-4 with
   no scheduler, never augments
                               (reference: kfold_train_ADVIT.py:63,84-85,225)
 - 'mnet':        Mnet, padded to (91, 109, 91), SGD 1e-3 momentum 0.9,
   MultiStep[6, 21]            (reference: kfold_train_Mnet.py:64,85-86,226)

`run_holdout` is the hold-out driver (reference: train_adversarial.py).

`run_kfold` and `run_holdout` join the process group first
(`--coordinator_address`, `--num_processes`, `--process_id`;
`_init_multihost`), before any file or CUDA side effect; then every rank
runs the same folds on its rows of each batch, and only rank 0 logs and
writes. Each rank draws its own `--randint True` seed, as each process of
the JAX package does.

The splits are sklearn's `KFold(n_splits, shuffle=True, random_state=seed)`
and `train_test_split(test_size=0.2, random_state=seed)`, written in numpy
with the same draws (`np.random.RandomState(seed)`), so that the port needs
no sklearn; a test holds them to sklearn's indices. One RAM-cached
VolumeSource is shared across folds.
"""

from __future__ import annotations

import math
import os
import random
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import Options, str2bool
from ..data.adni import ADNI
from ..data.pipeline import Loader, VolumeSource
from ..parallel import NullLogger, init_distributed, is_primary
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
        return dict(model=model, pad_to=None, drop_last=True,
                    optimizer=opt.optimizer, lr=opt.lr, momentum=0.0,
                    milestones=None, epochs=opt.epochs, aug=opt.aug_bool,
                    modalities=("MRI", "PET"))
    if variant == "single":
        return dict(model="single", pad_to=None, drop_last=False,
                    optimizer=opt.optimizer, lr=opt.lr, momentum=0.0,
                    milestones=None, epochs=opt.epochs, aug=opt.aug_bool,
                    modalities=("MRI",))
    # the ADVIT and Mnet reference drivers hard-code 40 epochs
    # (kfold_train_ADVIT.py:225, kfold_train_Mnet.py:226), the default
    # stage1 + stage2 sum, so opt.epochs keeps that default and stays
    # overridable
    if variant == "advit":
        return dict(model="advit", pad_to=(128, 128, 79), drop_last=True,
                    optimizer="Adam", lr=1e-4, momentum=0.0, milestones=(),
                    epochs=opt.epochs, aug=False, modalities=("MRI", "PET"))
    if variant == "mnet":
        return dict(model="mnet", pad_to=(91, 109, 91), drop_last=True,
                    optimizer="SGD", lr=1e-3, momentum=0.9, milestones=(6, 21),
                    epochs=opt.epochs, aug=opt.aug_bool,
                    modalities=("MRI", "PET"))
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
        **_dist_fields(opt),
    )


def _dist_fields(opt: Options) -> Dict:
    """The TrainerConfig fields of the multi-process flags."""
    return dict(coordinator_address=opt.coordinator_address or None,
                num_processes=opt.num_processes or None,
                process_id=opt.process_id if opt.process_id >= 0 else None)


def _init_multihost(opt: Options) -> bool:
    """Join the process group (a no-op single-process) before any logger,
    file or other CUDA side effect, and report whether this process owns
    them (rank 0)."""
    init_distributed(**dict(zip(
        ("coordinator_address", "num_processes", "process_id"),
        _dist_fields(opt).values())), device=opt.device)
    return is_primary()


def run_kfold(opt: Options, variant: str = "adversarial",
              pad_to_override=None) -> Dict[str, List[float]]:
    """Train and test every fold (or the `--folds` subset) and aggregate.
    `pad_to_override` replaces the variant's padded volume (a small plane
    for ADVIT on the CPU). Returns the mean, std and per-fold [loss, acc,
    sen, spe, f1, auc], the seed, and the type name of each fold's train
    feed."""
    save_dir = os.path.join(opt.checkpoints_dir, opt.name)
    primary = _init_multihost(opt)
    logger_main = Logger(save_dir) if primary else NullLogger()
    spec = _variant_spec(variant, opt)
    if pad_to_override is not None:
        spec["pad_to"] = pad_to_override

    data = ADNI(opt.dataroot, "ADNI.csv", opt.task).data_dict
    extra: List = []
    if opt.task == "pMCIsMCI" and opt.extra_sample == "True":
        extra = ADNI(opt.dataroot, "ADNI.csv", "ADCN").data_dict

    source = VolumeSource(data + extra, keys=spec["modalities"],
                          pad_to=spec["pad_to"], dtype=transfer_dtype(opt))
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
        trainer = Trainer(cfg, Logger(fold_dir) if primary else None)
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


def partition_dataset(data: List, ratios,
                      seed: Optional[int] = None) -> List[List]:
    """Fraction-based split (monai's partition_dataset with shuffle=True,
    reference: datasets/__init__.py:44,79): the indices shuffled by
    `np.random.default_rng(seed)`, parts of round(n * r / sum) items, the
    last taking the rest."""
    idx = np.arange(len(data))
    np.random.default_rng(seed).shuffle(idx)
    total = float(sum(ratios))
    parts, start = [], 0
    for i, r in enumerate(ratios):
        n = (int(round(len(data) * r / total)) if i < len(ratios) - 1
             else len(data) - start)
        parts.append([data[j] for j in idx[start:start + n]])
        start += n
    return parts


def run_holdout(opt: Options) -> Optional[List[float]]:
    """Hold-out driver (reference: train_adversarial.py:17-198): ModelAd or
    ModelCNNAd with heads=8 (reference: train_adversarial.py:30-31).

    Dataset modes (reference: datasets/__init__.py:35-98):
     - 'ADNI':   60/20/20 partition of ADNI.csv (the default)
     - 'ADNI12': train / val 80/20 of ADNI1_modality_complete.csv, test on
                 ADNI2_modality_complete.csv
     - task 'pretrain': 80/20 of the ADCN records with seed 965 and no test
                 set, so the result is None
    The partitions are saved as train.npy / val.npy / test.npy (arrays of
    record dicts, allow_pickle) under the run's directory. Returns the
    test [loss, acc, sen, spe, f1, auc]."""
    save_dir = os.path.join(opt.checkpoints_dir, opt.name)
    primary = _init_multihost(opt)
    logger = Logger(save_dir) if primary else NullLogger()
    # `task_seed` is drawn where JAX's `run_holdout` draws it: for the
    # partition, the loader and the Trainer (three draws with --randint)
    if opt.dataset == "ADNI12":
        adni1 = ADNI(opt.dataroot, "ADNI1_modality_complete.csv", opt.task)
        adni2 = ADNI(opt.dataroot, "ADNI2_modality_complete.csv", opt.task)
        train_d, val_d = partition_dataset(adni1.data_dict, [0.8, 0.2],
                                           seed=task_seed(opt))
        test_d = adni2.data_dict
    elif opt.task == "pretrain":
        data = ADNI(opt.dataroot, "ADNI.csv", "ADCN").data_dict
        train_d, val_d = partition_dataset(data, [0.8, 0.2], seed=965)
        test_d = []
    else:
        data = ADNI(opt.dataroot, "ADNI.csv", opt.task).data_dict
        train_d, val_d, test_d = partition_dataset(data, [0.6, 0.2, 0.2],
                                                   seed=task_seed(opt))
    if primary:  # partition snapshots: one writer
        for name, part in (("train", train_d), ("val", val_d),
                           ("test", test_d)):
            np.save(os.path.join(save_dir, f"{name}.npy"), part,
                    allow_pickle=True)

    source = VolumeSource(train_d + val_d + test_d,
                          dtype=transfer_dtype(opt))
    n1, n2 = len(train_d), len(train_d) + len(val_d)
    train_loader = Loader(source, list(range(n1)), opt.batch_size,
                          shuffle=True, drop_last=True, seed=task_seed(opt),
                          prefetch=opt.prefetch)
    val_loader = Loader(source, list(range(n1, n2)), opt.batch_size)
    test_loader = (Loader(source, list(range(n2, len(source))),
                          opt.batch_size) if test_d else None)

    cfg = TrainerConfig(
        model={"Transformer": "ad", "CNN": "cnn_ad"}[opt.model],
        dim=opt.dim, depth=opt.trans_enc_depth, heads=8,
        dropout=opt.dropout, optimizer=opt.optimizer, lr=opt.lr,
        weight_decay=opt.weight_decay, epochs=opt.epochs,
        aug=opt.aug_bool, aug_exact=str2bool(opt.aug_exact),
        seed=task_seed(opt), save_dir=save_dir, dtype=opt.dtype or "auto",
        resume=opt.resume == "True", device=opt.device)
    weights = dataset_weights(train_d)
    class_weights = weights if opt.use_class_weights == "True" else None
    trainer = Trainer(cfg, logger)
    res = trainer.fit(train_loader, val_loader, test_loader,
                      class_weights=class_weights)
    logger.print_message(f"Total params: {trainer.param_count()}")
    return res
