"""K-fold adversarial training driver (the README's main entry point).

Usage matches the reference (reference: README.md:45), on the card unless
`--device cpu` is given:

  python -m transmf_ad_tpu_torch.cli.kfold_train_adversarial \\
      --randint False --aug True --batch_size 8 --name <exp> \\
      --task <ADCN|pMCIsMCI> --model <CNN|Transformer> --dataroot <dir>
"""

from __future__ import annotations

import sys

from ..config import Option
from ..train.kfold import run_kfold


def main(argv=None) -> dict:
    """Parse `argv` (the command line when None), run every fold and
    return `run_kfold`'s result."""
    opt = Option().parse(argv)
    return run_kfold(opt, variant="adversarial")


if __name__ == "__main__":
    main(sys.argv[1:])
