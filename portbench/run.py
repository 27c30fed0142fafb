"""Run one cell of BENCHMARK.json once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (the clock starts as this file starts) builds the program's object
for the cell and warms up every shape its traffic uses; the window then
measures for `--seconds`; with `--trace 1` a short profiled stretch
follows it and the per-layer metrics are read from it, else the end-to-end
metrics are reported. After the peak memory is read, the program's state
is freed and the plain reference checks what the timed path produced; the
numbers compared and their limits are the last lines on standard error and
the last key of the result line. A run on a machine without the cards the
cell asks for, or in whose process JAX or the JAX package was loaded,
exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import faulthandler  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import harness  # noqa: E402

LIMIT_S = 350  # a run's time limit is 360 s


def phase(name: str, log=sys.stderr) -> None:
    print(f"phase {name} {time.perf_counter() - T_START:.3f} s", file=log,
          flush=True)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


class Context:
    """What a per-layer metric's reader sees (`readers.py`)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def execute(args, device="cuda", bench=None, cell_files=None,
            log=sys.stderr):
    """Run the cell; returns the result dict (without printing it).
    `cell_files` = (entry, cfg, mix, limits) stands in for the files named
    in BENCHMARK.json, `device` for the card (the CPU tests use both)."""
    import torch

    from portbench.counts import model as model_counts

    bench = bench or harness.benchmark()
    entry, cfg, mix, limits = cell_files or harness.cell(args.workload, bench)
    if device == "cuda":
        harness.require_cards(entry["chips"])
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    per_pair = getattr(model_counts, mix["flops"])(cfg, mix["volume"])
    drv = harness.kind(mix["kind"]).CellRun(cfg, mix, args.seed, device,
                                              limits)
    drv.setup()
    setup_s = time.perf_counter() - T_START
    phase("setup", log)
    e2e, attempted, failed = drv.window(args.seconds)
    phase("window", log)

    trace = None
    if args.trace:
        from portbench import profiling

        trace = profiling.trace(drv.run_units, mix["trace_units"], log)
        phase("trace", log)
    peak = (torch.cuda.max_memory_allocated(device) if device == "cuda"
            else 0)

    numbers = drv.check()
    phase("check", log)
    checks = {k: {"value": numbers[k], "limit": lim["limit"]}
              for k, lim in limits.items()}
    correct = failed == 0 and all(c["value"] <= c["limit"]
                                  for c in checks.values())

    if args.trace:
        ctx = Context(trace=trace, window_s=drv.window_s, units=drv.units,
                      pairs_per_unit=drv.pairs_per_unit, cfg=cfg, mix=mix,
                      flops_per_pair=per_pair)
        metrics = {}
        for m in bench["per_layer"]:
            if not applies(m, args.workload):
                continue
            value = harness.load_module(
                harness.HERE / "metrics" / f"{m['name']}.py").read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e["setup_s"] = setup_s
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in bench["end_to_end"]
                   if applies(m, args.workload) and m["name"] in e2e}

    res = {"correct": bool(correct), "attempted": attempted, "failed": failed,
           "metrics": metrics}
    if device == "cuda":
        card = harness.card()
        res["device"] = {"platform": "gpu", "kind": card["name"],
                         "count": entry["chips"], "memory_peak_bytes": peak}
        res["card"] = card
    else:
        res["device"] = {"platform": "cpu", "kind": "cpu", "count": 1,
                         "memory_peak_bytes": 0}
    if trace is not None:
        res["device"]["busy_s"] = trace.busy_s
        res["device"]["window_s"] = trace.window_s
        res["breakdown"] = {"device_ops": trace.device_ops,
                            "idle_gaps": trace.idle_gaps}
    res["checks"] = checks
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=log)
    return res


def main(argv=None) -> int:
    args = parse(argv)
    # a run ends within its time limit: a hung one dumps where it hung
    faulthandler.dump_traceback_later(LIMIT_S - (time.perf_counter()
                                                 - T_START), exit=True)
    harness.set_cache_dirs()
    res = execute(args)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the process loaded {found}; no result",
              file=sys.stderr)
        return 4
    print(json.dumps(res, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
