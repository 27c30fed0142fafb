"""K-fold ADVIT baseline driver: volumes padded to (128, 128, 79), Adam 1e-4
without a scheduler, never augmenting (reference: kfold_train_ADVIT.py), on
the card unless `--device cpu` is given:

  python -m transmf_ad_tpu_torch.cli.kfold_train_ADVIT --dataroot <dir> \\
      --task ADCN --batch_size 8

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
    return run_kfold(opt, variant="advit")


if __name__ == "__main__":
    main(sys.argv[1:])
