"""On the card (`cuda` marker; skipped without one): each cell's
program reads within its limits and its fp8 control does not, at the
cell's own size, on one seed a cell: `portbench/calibrate.py` in a
subprocess, as the limits were read (run: `python -m pytest
portbench/tests/test_portbench_card.py -m cuda -q`)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench import harness


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  harness.benchmark()["workloads"]])
def test_program_passes_and_control_fails(card, cell):
    out = subprocess.run(
        [sys.executable, str(harness.HERE / "calibrate.py"), "--workload",
         cell, "--seeds", "2222333344", "--control"],
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    limits = harness.cell(cell)[3]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert all(res["program"][k] <= v["limit"] for k, v in limits.items())
    assert any(res["control"][k] > v["limit"] for k, v in limits.items())
