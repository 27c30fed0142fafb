"""Standalone evaluation: test metrics from a saved checkpoint.

Extends the reference surface (which can only evaluate inside a training
run, reference: kfold_train_adversarial.py:229-250):

  python -m transmf_ad_tpu_torch.cli.evaluate --name EXP --task ADCN \\
      --model Transformer --dataroot /data/ADNI \\
      --checkpoint 'checkpoints/EXP/0/best_label_*.pt' [--fold 0]

`--checkpoint` is a glob of `.pt` files (the last match in sorted order is
taken), the port's or a reference run's (read through
`utils/torch_import.py`, which skips what the reference forward never
reads); the other flags are the training CLI's. `--model` is Transformer
(ModelAd), CNN (ModelCNNAd) or any key of the model registry, as in the JAX
package's `evaluate.py`; the volumes are read as the model's k-fold driver
reads them: MRI alone for 'single', padded to (128, 128, 79) for 'advit'
and to (91, 109, 91) for 'mnet' (the JAX package's `evaluate.py` pads
nothing, so it cannot score an ADVIT checkpoint). Without `--fold` every
record of the task is scored; with `--fold F` the test indices of fold F
of the k-fold split the training run used (`--num_folds`, the task's
seed). Volumes are cached in the training run's transfer dtype, so a
checkpoint's logged test metrics come back.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import sys

from ..config import Option
from ..data.adni import ADNI
from ..data.pipeline import Loader, VolumeSource
from ..train.kfold import (_make_trainer_cfg, _variant_spec, kfold_split,
                           task_seed, transfer_dtype)
from ..train.trainer import Trainer, _fmt_metrics


def main(argv=None) -> dict:
    """Parse `argv` (the command line when None), print the test metrics
    and return them."""
    extra = argparse.ArgumentParser(add_help=False)
    extra.add_argument("--checkpoint", type=str, required=True)
    extra.add_argument("--fold", type=int, default=None)
    ns, rest = extra.parse_known_args(argv)
    opt = Option().parse(rest)
    model = {"Transformer": "ad", "CNN": "cnn_ad"}.get(opt.model, opt.model)
    variant = model if model in ("single", "advit", "mnet") else "adversarial"
    # the adversarial spec names its model by --model; it is replaced below
    spec = dict(_variant_spec(variant, dataclasses.replace(
        opt, model="Transformer")), model=model)

    records = ADNI(opt.dataroot, "ADNI.csv", opt.task).data_dict
    source = VolumeSource(records, keys=spec["modalities"],
                          pad_to=spec["pad_to"], dtype=transfer_dtype(opt))
    seed = task_seed(opt)
    indices = None
    if ns.fold is not None:
        folds = list(kfold_split(len(records), opt.num_folds, seed))
        indices = list(folds[ns.fold][1])
    loader = Loader(source, indices, batch_size=opt.batch_size)

    paths = sorted(glob.glob(ns.checkpoint))
    if not paths:
        raise SystemExit(f"no checkpoint matches {ns.checkpoint}")

    cfg = _make_trainer_cfg(opt, spec, f"{opt.checkpoints_dir}/{opt.name}",
                            seed)
    trainer = Trainer(cfg)  # rank 0 logs to cfg.save_dir
    m = trainer.evaluate_from_checkpoint(loader, paths[-1])
    print(_fmt_metrics(m))
    return m


if __name__ == "__main__":
    main(sys.argv[1:])
