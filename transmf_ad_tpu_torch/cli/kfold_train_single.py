"""K-fold single-modality (MRI-only sNet) driver (reference:
kfold_train_single.py), on the card unless `--device cpu` is given:

  python -m transmf_ad_tpu_torch.cli.kfold_train_single --dataroot <dir> \\
      --task ADCN --batch_size 8 --aug True

It takes the flags of the training CLI (`config.Option`).
"""

from __future__ import annotations

import sys

from ..config import Option
from ..train.kfold import run_kfold


def main(argv=None) -> dict:
    """Parse `argv` (the command line when None), run every fold and
    return `run_kfold`'s result."""
    opt = Option().parse(argv)
    return run_kfold(opt, variant="single")


if __name__ == "__main__":
    main(sys.argv[1:])
