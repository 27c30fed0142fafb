"""CLI options: reference-compatible flag surface.

Port of transmf_ad_tpu/config.py, which mirrors the reference Option class
(reference: options/option.py:6-72): same flags, same defaults,
string-typed booleans ('True'/'False' comparisons), and the same `opt.txt`
snapshot written under `<checkpoints_dir>/<name>/`.

Differences from the JAX package's flags: `--use_pallas` is gone (the
tensor's device picks between a kernel and its plain version), the
multi-host flags (`--coordinator_address`, `--num_processes`,
`--process_id`) wait for the multi-GPU port, and `--device` (default
`cuda`) is the one way to ask for the CPU.
"""

from __future__ import annotations

import argparse
import os
from dataclasses import dataclass
from typing import Optional


def str2bool(v: str) -> bool:
    return str(v) == "True"


@dataclass
class Options:
    name: str = "ADCN_CNN"
    dataroot: str = "./data/ADNI"
    aug: str = "True"
    mode: str = "train"
    dataset: str = "ADNI"
    model: str = "Transformer"
    randint: str = "False"
    extra_sample: str = "False"
    checkpoints_dir: str = "./checkpoints"
    task: str = "ADCN"
    batch_size: int = 2
    lr: float = 1e-4
    optimizer: str = "Adam"
    stage1_epochs: int = 20
    stage2_epochs: int = 20
    weight_decay: float = 0.0
    dim: int = 128
    trans_enc_depth: int = 3
    cross_attn_depth: int = 3
    dropout: float = 0.0
    init_type: str = "normal"
    # --- extensions beyond the reference CLI ---
    heads: int = 4
    num_folds: int = 5
    resume: str = "False"
    prefetch: int = 2
    dtype: Optional[str] = None  # 'bfloat16'/'float32'/None(auto: bf16 on CUDA)
    # volume cache/transfer dtype: 'auto' follows --dtype; 'uint8'
    # quantizes the normalized volume (1/4 the float32 bytes in RAM,
    # over the host-to-card link and in the card's dataset cache;
    # dequantized on the card — data/pipeline.py::VolumeSource)
    feed_dtype: str = "auto"
    use_class_weights: str = "False"  # weight CE by inverse class frequency
    pretrained: str = ""  # checkpoint to load before training (e.g. pretrainAD)
    remat: str = "False"  # rematerialize encoders (not ported yet: raises)
    debug_nans: str = "False"  # not ported: raises
    aug_exact: str = "False"  # exact-MONAI host augmentation (data/exact_monai.py)
    folds: str = ""  # comma-separated fold subset, e.g. "0,2" (default: all)
    # — redo a single fold; the KFold split itself stays identical (same
    # seed, all folds laid out), only which folds TRAIN is filtered
    device: str = "cuda"  # 'cuda' or 'cpu'

    @property
    def aug_bool(self) -> bool:
        return str2bool(self.aug)

    @property
    def epochs(self) -> int:
        return self.stage1_epochs + self.stage2_epochs


class Option:
    """argparse wrapper with the reference's parse/print/save behavior."""

    def __init__(self):
        self.parser = argparse.ArgumentParser(
            formatter_class=argparse.ArgumentDefaultsHelpFormatter
        )
        defaults = Options()
        for f, v in vars(defaults).items():
            t = type(v) if v is not None else str
            self.parser.add_argument(f"--{f}", type=t, default=v)
        self.opt: Optional[Options] = None

    def parse(self, args=None) -> Options:
        ns = self.parser.parse_args(args)
        self.opt = Options(**vars(ns))
        self.print_options(self.opt)
        return self.opt

    def print_options(self, opt: Options):
        message = "----------------- Options ---------------\n"
        defaults = Options()
        for k in sorted(vars(opt)):
            v = getattr(opt, k)
            comment = ""
            default = getattr(defaults, k)
            if v != default:
                comment = f"\t[default: {default}]"
            message += f"{str(k):>25}: {str(v):<30}{comment}\n"
        print(message)
        expr_dir = os.path.join(opt.checkpoints_dir, opt.name)
        os.makedirs(expr_dir, exist_ok=True)
        with open(os.path.join(expr_dir, "opt.txt"), "wt") as f:
            f.write(message + "\n")
