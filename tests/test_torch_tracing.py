"""The port's tracer (`transmf_ad_tpu_torch/utils/tracing.py`) on a tiny
ModelAd train step on the CPU (no JAX).

- Off: `span` returns the shared no-op, `count` counts nothing, and a step
  leaves nothing to drain.
- On: one step records one "step" span whose children are the seven
  phases, all with the step's id and inside its interval; an augmented
  step reads the generator once ("sync" inside "augment", `host_syncs`
  1), a step without augmentation never; the encoder blocks' spans sit in
  "forward"; the `op.<name>.calls` counters equal the `transmf::` op calls
  a dispatch mode sees, and every op has its host time.
- The clock: a span and the record_function range it opens under a
  profiler start and end within 100 us of each other on the profiler's
  clock.
"""

import collections
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from transmf_ad_tpu_torch.data.transforms import AugmentConfig
from transmf_ad_tpu_torch.models import build_model
from transmf_ad_tpu_torch.train import create_state, make_train_step
from transmf_ad_tpu_torch.utils import tracing

PHASES = ["prep", "augment", "forward", "loss", "backward", "grad_reduce",
          "optimizer"]
FLIP = AugmentConfig(flip_prob=1.0)  # every sample resampled


@pytest.fixture(autouse=True)
def _clean():
    """Each test starts and ends with the tracer off and empty."""
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()


@pytest.fixture(scope="module")
def state():
    torch.manual_seed(0)
    model = build_model("ad", dim=16, heads=2, dim_head=8, mlp_dim=64)
    return create_state(model, device="cpu", dtype=torch.float32, seed=0,
                        name="Adam", lr=1e-4)


def _batch():
    g = torch.Generator().manual_seed(1)
    return {"MRI": torch.rand(2, 32, 36, 32, generator=g),
            "PET": torch.rand(2, 32, 36, 32, generator=g),
            "label": torch.tensor([0, 1])}


def _traced_step(state, aug_cfg):
    step = make_train_step(aug_cfg=aug_cfg)
    tracing.enable()
    step(state, _batch())
    tracing.disable()
    return tracing.drain()


def test_off_records_nothing(state):
    assert tracing.span("step", 3) is tracing.NOOP
    assert tracing.span("conv") is tracing.NOOP
    with tracing.span("conv"):
        tracing.count("host_syncs")
    make_train_step(aug_cfg=FLIP)(state, _batch())
    assert tracing.drain() == ([], {})


def test_step_spans(state):
    spans, counters = _traced_step(state, FLIP)
    (step,) = [s for s in spans if s.name == "step"]
    assert step.parent is None and step.step is not None
    assert step.n == state.step - 1
    children = [s for s in sorted(spans, key=lambda s: s.start_ns)
                if s.parent == step.id]
    assert [s.name for s in children] == PHASES
    assert {s.step for s in spans} == {step.step}
    assert len({s.thread for s in spans}) == 1
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.parent is not None:
            up = by_id[s.parent]
            assert up.start_ns <= s.start_ns <= s.end_ns <= up.end_ns
    for a, b in zip(children, children[1:]):
        assert a.end_ns <= b.start_ns
    (sync,) = [s for s in spans if s.name == "sync"]
    assert by_id[sync.parent].name == "augment"
    assert counters["host_syncs"] == 1
    forward = next(s for s in children if s.name == "forward")
    blocks = [s for s in spans if s.name.startswith("encoder ")]
    assert len(blocks) == 14 and all(s.parent == forward.id for s in blocks)
    assert {by_id[s.parent].name for s in spans
            if s.name in ("conv", "BatchNorm statistics")} == {
                s.name for s in blocks}
    assert {s.name for s in spans if s.parent == forward.id} == {
        *(s.name for s in blocks), "D", "fuse_transformer", "fc_cls"}


def test_no_sync_without_augmentation(state):
    spans, counters = _traced_step(state, None)
    names = [s.name for s in spans]
    assert "sync" not in names and "augment" not in names
    assert "host_syncs" not in counters
    (step,) = [s for s in spans if s.name == "step"]
    assert [s.name for s in sorted(spans, key=lambda s: s.start_ns)
            if s.parent == step.id] == [p for p in PHASES if p != "augment"]


class _OpCalls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.calls = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "transmf":
            self.calls[func._opname] += 1
        return func(*args, **(kwargs or {}))


def test_op_counters_match_the_op_calls(state):
    step = make_train_step(aug_cfg=FLIP)
    tracing.enable()
    with _OpCalls() as seen:
        step(state, _batch())
    tracing.disable()
    _, counters = tracing.drain()
    calls = {k.split(".")[1]: v for k, v in counters.items()
             if k.endswith(".calls")}
    assert calls == dict(seen.calls)
    assert {"stem_conv_stats", "stem_dw", "affine_act_pool",
            "affine_act_pool_bwd", "attention", "token_pool"} <= set(calls)
    for name in calls:
        assert counters[f"op.{name}.host_ns"] > 0


def test_counters_add():
    tracing.enable()
    tracing.count("a")
    tracing.count("a", 4)
    tracing.count("b", 2)
    tracing.disable()
    tracing.count("a")
    assert tracing.drain()[1] == {"a": 5, "b": 2}


def test_span_on_the_profilers_clock():
    """The range a span opens under a profiler, and the span, agree within
    100 us at both ends (start_ns is Unix-epoch ns on both); without
    `ranges` no range is opened."""
    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(5):
            with tracing.span("iteration", i):
                with tracing.span("inner"):
                    torch.ones(64).sum()
        tracing.enable(ranges=False)
        with tracing.span("unranged"):
            pass
    spans, _ = tracing.drain()
    events = collections.defaultdict(list)
    for e in sorted(prof.profiler.kineto_results.events(),
                    key=lambda e: e.start_ns()):
        events[e.name()].append(e)
    assert "unranged" not in events
    spans = [s for s in sorted(spans, key=lambda s: s.start_ns)
             if s.name != "unranged"]
    assert len(spans) == 10
    for s in spans:
        e = events[s.name if s.n is None else f"{s.name} {s.n}"].pop(0)
        assert abs(e.start_ns() - s.start_ns) < 100_000
        end = e.start_ns() + e.duration_ns()
        assert abs(end - s.end_ns) < 100_000


def test_spans_nest_per_thread():
    """A span opened on another thread has no parent there; each thread
    keeps its own stack."""
    def other():
        with tracing.span("other"):
            pass

    tracing.enable()
    with tracing.span("step", 0):
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        with tracing.span("inner"):
            pass
    spans = {s.name: s for s in tracing.drain()[0]}
    assert spans["other"].parent is None and spans["other"].step is None
    assert spans["inner"].parent == spans["step"].id
    assert spans["inner"].step == spans["step"].step
    assert spans["other"].thread != spans["step"].thread
