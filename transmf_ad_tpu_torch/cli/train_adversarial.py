"""Hold-out adversarial training driver: a 60/20/20 partition, ModelAd (or
ModelCNNAd) with heads=8 (reference: train_adversarial.py), on the card
unless `--device cpu` is given:

  python -m transmf_ad_tpu_torch.cli.train_adversarial --dataroot <dir> \\
      --task ADCN --model Transformer --batch_size 8

`--dataset ADNI12` trains on ADNI1 and tests on ADNI2; `--task pretrain`
trains on an 80/20 split of the ADCN records with no test set. It takes
the flags of the training CLI (`config.Option`).
"""

from __future__ import annotations

import sys

from ..config import Option
from ..train.kfold import run_holdout


def main(argv=None):
    """Parse `argv` (the command line when None), train and return
    `run_holdout`'s test metrics (None for `--task pretrain`)."""
    opt = Option().parse(argv)
    return run_holdout(opt)


if __name__ == "__main__":
    main(sys.argv[1:])
