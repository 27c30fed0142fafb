"""K-fold MiSePyNet / Mnet baseline driver: volumes padded to (91, 109, 91),
SGD 1e-3 momentum 0.9 with MultiStep[6, 21] (reference: kfold_train_Mnet.py),
on the card unless `--device cpu` is given:

  python -m transmf_ad_tpu_torch.cli.kfold_train_Mnet --dataroot <dir> \\
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
    return run_kfold(opt, variant="mnet")


if __name__ == "__main__":
    main(sys.argv[1:])
