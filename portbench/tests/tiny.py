"""A cell of BENCHMARK.json cut to a size the CPU runs in seconds: the
configuration's widths and the mix's batch, volume and pool shrunk, every
other setting (traffic kind, augmentation, limits) as the cell has it.
Used by the CPU tests; the program runs its plain PyTorch versions."""

from __future__ import annotations

import copy
import sys

from portbench import harness

TINY_MODEL = {"dim": 16, "heads": 2, "dim_head": 8, "mlp_dim": 64}
TINY_VOLUME = [32, 36, 32]  # a 2 x 2 x 2 token grid
CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


def cell_files(name, bench=None, compute_dtype="float32"):
    entry, cfg, mix, limits = harness.cell(name, bench)
    cfg, mix = copy.deepcopy(cfg), copy.deepcopy(mix)
    cfg["model"].update(TINY_MODEL)
    cfg["compute_dtype"] = compute_dtype
    mix["volume"] = TINY_VOLUME
    mix.update(batch=4, pool_pairs=16, pool_dtype="float32", trace_units=1)
    return entry, cfg, mix, limits


def run(name, seed=3000000019, seconds=0.5, trace=0, **kw):
    """`run.execute` of the tiny cell on the CPU -> the result dict."""
    import io

    import torch

    from portbench import run as runner

    torch.manual_seed(0)
    args = runner.parse(["--workload", name, "--seed", str(seed),
                         "--seconds", str(seconds), "--trace", str(trace)])
    bench = harness.benchmark()
    return runner.execute(args, device="cpu", bench=bench,
                          cell_files=cell_files(name, bench, **kw),
                          log=io.StringIO())


if __name__ == "__main__":  # python -m portbench.tests.tiny <cell>
    import json

    print(json.dumps(run(sys.argv[1])))
