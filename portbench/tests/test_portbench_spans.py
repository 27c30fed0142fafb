"""The readers of the program's spans (`portbench/spans.py`): the tiny CPU
cell with `--trace 1` reports the three host metrics and leaves the
device one out; `charge` gives device time and idle gaps to the right
spans on a made-up time line."""

from __future__ import annotations

import pytest

from portbench import spans
from portbench.tests import tiny
from transmf_ad_tpu_torch.utils.tracing import Span

HOST = ("host_issue_ms_per_step.train", "sync_wait_ms_per_step.train",
        "op_dispatch_us.train")


@pytest.mark.parametrize("cell", tiny.CELLS[:1])
def test_tiny_cell_reports_the_host_metrics(cell):
    res = tiny.run(cell, trace=1)
    assert res["correct"]
    got = res["metrics"]
    for name in HOST:
        assert got[name]["value"] > 0, name
    assert "augment_ms_per_step.train" not in got  # no card: no stretch D
    # the result line keeps the keys it had
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def _span(name, start, end, id_, parent=None, step=1):
    return Span(name, None, start, end, id_, parent, 0, step)


def test_charge():
    """step [0, 100] > augment [10, 40] > sync [30, 40]; forward [40, 90];
    a span outside any step [200, 210]. Operations launched at 5
    (step), 15 and 35 (augment, sync), 50 (forward), 205 (outside), and
    one whose launch was not found."""
    sp = [_span("step", 0, 100, 1), _span("augment", 10, 40, 2, 1),
          _span("sync", 30, 40, 3, 2), _span("forward", 40, 90, 4, 1),
          _span("other", 200, 210, 5, step=None)]
    ops = [(5, 100, 110), (15, 110, 130), (35, 300_200, 300_210),
           (50, 300_210, 300_250), (205, 300_260, 300_270),
           (None, 300_270, 300_280)]
    got = spans.charge(sp, ops, units=2)
    ms = 1e-6 / 2
    assert got["by_span_ms"] == pytest.approx(
        {"augment": 20 * ms, "step": 10 * ms, "sync": 10 * ms,
         "forward": 40 * ms, "other": 10 * ms})
    assert got["busy_ms"] == pytest.approx(100 * ms)
    # gaps: 130 -> 300200 (closed by sync's launch), 300250 -> 300260
    assert got["idle_by_span_ms"] == pytest.approx(
        {"sync": 300_070 * ms, "other": 10 * ms})
    assert got["in_step_pct"] == pytest.approx(100 * 80 / 100)
    assert got["launched_in_span_pct"] == pytest.approx(90.0)
    assert got["found_pct"] == pytest.approx(90.0)
    assert got["idle_charged_pct"] == pytest.approx(100.0)
    assert got["gaps_over_100us_uncharged"] == 0


def test_host_numbers():
    sp = [_span("step", 0, 10_000_000, 1),
          _span("sync", 1_000_000, 4_000_000, 2, 1),
          _span("step", 10_000_000, 18_000_000, 3, step=2),
          _span("sync", 11_000_000, 12_000_000, 4, 3, step=2)]
    got = spans.host_numbers(sp, {"op.a.calls": 3, "op.a.host_ns": 30_000,
                                  "op.b.calls": 1, "op.b.host_ns": 10_000,
                                  "host_syncs": 2}, units=2)
    assert got == pytest.approx({"host_issue_ms": 7.0, "sync_wait_ms": 2.0,
                                 "op_dispatch_us": 10.0})
    assert spans.host_numbers(sp, {}, 2)["op_dispatch_us"] is None
