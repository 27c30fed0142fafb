"""Every cell, configuration, mix, limit and metric of BENCHMARK.json is
found by its name, and a cell added as new files runs without an edit to a
file the benchmark has."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

from portbench import harness, peaks
from portbench.counts import model

REPO = Path(__file__).resolve().parents[2]


def test_every_name_resolves():
    bench = harness.benchmark()
    names = {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        cfg = harness.load_json(REPO / c["file"])
        assert cfg["name"] == c["name"]
        assert (harness.HERE / "reference" / f"{cfg['reference']}.py").exists()
    for w in bench["workloads"]:
        assert w["config"] in names
        _, cfg, mix, limits = harness.cell(w["name"], bench)
        assert harness.kind(mix["kind"]).CellRun
        assert limits and all("limit" in v for v in limits.values())
    for m in bench["per_layer"]:
        mod = harness.load_module(harness.HERE / "metrics" / f"{m['name']}.py")
        assert callable(mod.read)
        assert set(m["workloads"]) <= {w["name"] for w in bench["workloads"]}


def test_new_cell_runs_from_new_files_alone(tmp_path):
    """Copy the benchmark, add a cell of a new architecture as files of its
    own (a reference module, its model count, a count of a new op, a mix,
    a configuration, limits, metric readers) plus its entries, and run it
    untraced and traced: no file that was there changes. The architecture
    is ModelAd under a name the benchmark does not know, so the program
    runs it."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.HERE, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = harness.benchmark()
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*")
              if p.is_file()}
    new = root / "portbench"
    (new / "reference/model_ad_alias.py").write_text(
        "from .model_ad import ADVERSARIAL, Model  # noqa: F401\n")
    (new / "counts/models/model_ad_alias.py").write_text(
        "from .model_ad import forward_per_pair  # noqa: F401\n")
    (new / "counts/ops/alias_op.py").write_text(
        "def outputs(shapes):\n    return [(shapes[0], None)]\n\n\n"
        "def ops(shapes):\n    return 7e6, 'f32'\n")
    (new / "traffic/train_tiny.json").write_text(json.dumps({
        "kind": "train_step", "batch": 2, "volume": [32, 36, 32],
        "pool_pairs": 6, "pool_dtype": "float32", "augment": None,
        "lr": 1e-4, "flops": "train_per_pair", "trace_units": 1}))
    cfg = harness.load_json(harness.HERE / "configs/model_ad.json")
    cfg.update(name="alias_tiny", reference="model_ad_alias",
               compute_dtype="float32")
    cfg["model"].update(dim=16, heads=2, dim_head=8, mlp_dim=64)
    (new / "configs/alias_tiny.json").write_text(json.dumps(cfg))
    (new / "limits/tiny_train.json").write_text(json.dumps(
        {"out": {"limit": 1e-3}, "grad": {"limit": 1e-2},
         "update": {"limit": 1e-2}}))
    (new / "metrics/units.tiny.py").write_text(
        "def read(ctx):\n    return float(ctx.units)\n")
    (new / "metrics/flops.tiny.py").write_text(
        "def read(ctx):\n    return float(ctx.flops_per_pair)\n")
    bench["configs"].append({"name": "alias_tiny", "source": "test",
                             "file": "portbench/configs/alias_tiny.json",
                             "reduced": ["dim"], "why": "test"})
    bench["workloads"].append({"name": "tiny_train", "config": "alias_tiny",
                               "traffic": "train_tiny", "chips": 1,
                               "why": "test"})
    bench["end_to_end"][0]["workloads"].append("tiny_train")
    for name in ("units.tiny", "flops.tiny"):
        bench["per_layer"].append({"name": name, "unit": "n",
                                   "better": "higher", "source": "host_clock",
                                   "layer": "test",
                                   "moves": "train_pairs_per_s",
                                   "workloads": ["tiny_train"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import sys, json; sys.path.insert(0, sys.argv[1]);"
            "from portbench import run; from portbench.counts import kernels;"
            "print(json.dumps(kernels.least_time_s('alias_op', [[2, 3]],"
            " ['float'])));"
            "a = run.parse(['--workload', 'tiny_train', '--seed', '7',"
            " '--seconds', '0.3', '--trace', sys.argv[2]]);"
            "print(json.dumps(run.execute(a, device='cpu')))")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    tiny_ad = dict(cfg, reference="model_ad")
    for trace in ("0", "1"):
        out = subprocess.run([sys.executable, "-c", code, str(root), trace],
                             capture_output=True, text=True, env=env,
                             timeout=300)
        assert out.returncode == 0, out.stderr[-3000:]
        lines = out.stdout.strip().splitlines()
        assert json.loads(lines[-2]) == [7e6 / peaks.FLOPS["float32"],
                                         "operations"]
        res = json.loads(lines[-1])
        assert res["correct"], res
        if trace == "1":
            assert res["metrics"]["units.tiny"]["value"] >= 1
            assert res["metrics"]["flops.tiny"]["value"] == \
                model.train_per_pair(tiny_ad, [32, 36, 32])
        else:
            assert set(res["metrics"]) == {"train_pairs_per_s", "setup_s"}
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_no_card_no_result(tmp_path):
    """Without a CUDA card the run exits non-zero and prints nothing on
    standard output."""
    out = subprocess.run(
        [sys.executable, str(harness.HERE / "run.py"), "--workload",
         harness.benchmark()["workloads"][0]["name"], "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA card" in out.stderr


def test_unknown_workload_fails():
    out = subprocess.run(
        [sys.executable, str(harness.HERE / "run.py"), "--workload",
         "no_such_cell", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
