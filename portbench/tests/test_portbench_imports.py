"""Nothing the benchmark loads is JAX or the JAX package (whole top-level
names), and the plain reference loads nothing of the program."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import types
from pathlib import Path

from portbench import harness

REPO = Path(__file__).resolve().parents[2]


def _modules_after(code: str) -> set:
    full = (f"import sys; sys.path.insert(0, {str(REPO)!r});" + code +
            "; import json; print(json.dumps(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", full], capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    """A whole tiny run of every cell, traced, in one process."""
    mods = _modules_after(
        "from portbench.tests import tiny;"
        "[tiny.run(w['name'], trace=1) for w in"
        " tiny.harness.benchmark()['workloads']]")
    tops = {m.split(".")[0] for m in mods}
    assert not tops & set(harness.FORBIDDEN), tops & set(harness.FORBIDDEN)
    assert "transmf_ad_tpu_torch" in tops  # the program under test ran


def test_reference_loads_nothing_of_the_program():
    """Every module of the plain reference and of the counts, as found on
    disk, so that a file a later cell adds is held to it too."""
    found = [f"portbench.{d.replace('/', '.')}.{p.stem}"
             for d in ("reference", "counts", "counts/models", "counts/ops")
             for p in sorted((harness.HERE / d).glob("*.py"))
             if p.stem != "__init__"]
    assert {"portbench.reference.model_ad", "portbench.counts.kernels",
            "portbench.counts.models.transformer_res"} <= set(found)
    mods = _modules_after(f"import importlib; [importlib.import_module(m)"
                          f" for m in {found!r}]")
    assert set(found) <= mods
    tops = {m.split(".")[0] for m in mods}
    assert not tops & {"transmf_ad_tpu_torch", *harness.FORBIDDEN}


def test_forbidden_names_compare_whole(monkeypatch):
    assert harness.forbidden_modules() == [] or "jax" not in sys.modules
    monkeypatch.setitem(sys.modules, "transmf_ad_tpu_torch_x",
                        types.ModuleType("transmf_ad_tpu_torch_x"))
    assert "transmf_ad_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "transmf_ad_tpu.ops",
                        types.ModuleType("transmf_ad_tpu.ops"))
    assert "transmf_ad_tpu" in harness.forbidden_modules()
