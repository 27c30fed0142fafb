"""The port's event engine, progress bar and logger against the JAX
package's (CPU, no model).

`Engine`: the order of events over a run, `terminate` and
`remove_event_handler`, the same on both sides. `ProgressBar`: the text on a
non-tty stream and on a tty, equal to the JAX package's for the same run
under the same fake clock (both read `time.perf_counter`, which the tests
replace by a counter that advances 0.25 s a call). `iter_progress`: silent
off a tty, the same text on one. `Logger`: the same `log.txt`.
"""

import io
import itertools
import os

import pytest

from transmf_ad_tpu.train import engine as j_engine
from transmf_ad_tpu.utils import logging as j_logging
from transmf_ad_tpu.utils import progress as j_progress
from transmf_ad_tpu_torch.train import engine
from transmf_ad_tpu_torch.utils import logging, progress

PACKAGES = {"jax": (j_engine, j_progress), "port": (engine, progress)}


class Tty(io.StringIO):
    def isatty(self):
        return True


def _events(eng_mod, terminate_at=None):
    """The events a 3-epoch run over 2 batches fires, in order, with the
    epoch and iteration at each."""
    seen = []
    eng = eng_mod.Engine(lambda e, b: b * 10)
    for ev in eng_mod.Events:
        eng.add_event_handler(
            ev, lambda e, ev=ev: seen.append(
                (ev.value, e.state.epoch, e.state.iteration, e.state.output)))
    if terminate_at is not None:
        @eng.on(eng_mod.Events.ITERATION_COMPLETED)
        def stop(e):
            if e.state.iteration == terminate_at:
                e.terminate()
    state = eng.run([1, 2], max_epochs=3)
    return seen, state.epoch, state.iteration


@pytest.mark.parametrize("terminate_at", [None, 3])
def test_event_order(terminate_at):
    port = _events(engine, terminate_at)
    assert port == _events(j_engine, terminate_at)
    seen, epoch, _ = port
    assert seen[0][0] == "started" and seen[-1][0] == "completed"
    assert epoch == (3 if terminate_at is None else 2)


def test_terminate_and_remove_handler():
    for eng_mod in (engine, j_engine):
        eng = eng_mod.Engine(lambda e, b: b)

        def stop(e):
            e.terminate()

        eng.add_event_handler(eng_mod.Events.EPOCH_COMPLETED, stop)
        assert eng.run([1], max_epochs=10).epoch == 1
        eng.remove_event_handler(stop, eng_mod.Events.EPOCH_COMPLETED)
        assert eng.run([1], max_epochs=3).epoch == 3
        assert eng.state.epoch_t0 > 0  # the epoch's start, for the trainer


def _fake_clock(monkeypatch):
    ticks = itertools.count()
    monkeypatch.setattr("time.perf_counter", lambda: 0.25 * next(ticks))


def _bar_text(which, stream, monkeypatch, total=5, **kw):
    eng_mod, prog = PACKAGES[which]
    _fake_clock(monkeypatch)
    eng = eng_mod.Engine(lambda e, b: b)
    prog.ProgressBar(file=stream, **kw).attach(eng, total=total)
    eng.run(range(5), max_epochs=2)
    return stream.getvalue()


@pytest.mark.parametrize("persist", [True, False])
@pytest.mark.parametrize("total", [5, None])
def test_progress_bar_text_tty(monkeypatch, persist, total):
    port = _bar_text("port", Tty(), monkeypatch, total, persist=persist,
                     min_interval=0.0)
    assert port == _bar_text("jax", Tty(), monkeypatch, total,
                             persist=persist, min_interval=0.0)
    assert "\r" in port and "Epoch [2/2]" in port
    if total:
        assert "[5/5] 100%" in port
    assert port.count("\n") == (2 if persist else 0)


@pytest.mark.parametrize("log_every", [2, 10])
def test_progress_bar_text_not_tty(monkeypatch, log_every):
    port = _bar_text("port", io.StringIO(), monkeypatch, log_every=log_every)
    assert port == _bar_text("jax", io.StringIO(), monkeypatch,
                             log_every=log_every)
    assert "Epoch [1/2] iteration 5/5 (" in port  # the last always logged
    assert "\r" not in port


@pytest.mark.parametrize("stream", [Tty, io.StringIO])
def test_iter_progress(monkeypatch, stream):
    texts = []
    for _, prog in PACKAGES.values():
        _fake_clock(monkeypatch)
        f = stream()
        assert list(prog.iter_progress(range(4), total=4, file=f)) == \
            [0, 1, 2, 3]
        texts.append(f.getvalue())
    assert texts[0] == texts[1]
    assert bool(texts[1]) == (stream is Tty)


def test_logger_log_file(tmp_path, capsys):
    logs = []
    for name, mod in (("jax", j_logging), ("port", logging)):
        d = str(tmp_path / name / "fold")
        log = mod.Logger(d)
        log.print_message("Training Results - Epoch[1] ")
        log.print_message_nocli("loss: 0.1000 accuracy: 1.0000")
        mod.Logger(d).print_message("second logger appends")
        logs.append(open(os.path.join(d, "log.txt")).read().replace(d, "D"))
    assert logs[0] == logs[1]
    assert logs[1].count("================ D/log.txt") == 2
    out = capsys.readouterr().out
    assert out.count("Training Results") == 2  # echoed by both, file-only not
    assert "loss: 0.1000" not in out
