"""The readers of the program's spans and marks (``benchmark/phases.py``
and its metrics) on a synthetic trace: two steps of marks, kernels on two
streams (one overlapping its neighbour, one started on the side stream
before the next mark), a copy, ops outside any phase, and host
``fmov::plan_chunk`` / ``fmov::pack_rows`` events; each reader's ms by
hand.  Without marks, spans or a trace, each reads None."""

from types import SimpleNamespace

import pytest

from benchmark import cells, phases
from benchmark.trace import Event, Trace

US = 1000  # ns


def _k(name, start_us, dur_us, lane=7, cat="kernel"):
    return Event(cat, name, start_us * US, dur_us * US, lane)


def _step(t):
    """One step's device ops from ``t`` us: pose 10, render 20 (two
    kernels on two streams, overlapping), loss 5 (a copy), backward 34
    (the side stream's stage starts before the update mark), update 4."""
    return [_k("fmov_mark_pose", t, 1), _k("void pose_kernel<float>(int)", t + 2, 10),
            _k("fmov_mark_render", t + 13, 1), _k("render_a", t + 15, 20),
            _k("render_b", t + 20, 10, lane=8),
            _k("fmov_mark_loss", t + 36, 1),
            _k("Memcpy HtoD (Pinned -> Device)", t + 38, 5, cat="gpu_memcpy"),
            _k("fmov_mark_backward", t + 44, 1), _k("bwd", t + 46, 30),
            _k("wgrad_kernel", t + 70, 10, lane=8),
            _k("fmov_mark_update", t + 82, 1), _k("adam", t + 84, 4),
            _k("fmov_mark_end", t + 89, 1), _k("after_end", t + 91, 2)]


HOST = [Event("user_annotation", "fmov::plan_chunk", 0, 50 * US, 1),
        Event("cuda_runtime", "cudaMemcpyAsync", 10 * US, 5 * US, 1),
        Event("user_annotation", "fmov::pack_rows", 60 * US, 30 * US, 1),
        Event("python_function", "fmov::pack_rows", 60 * US, 30 * US, 1),
        Event("user_annotation", "fmov::plan_chunk", 100 * US, 50 * US, 1),
        Event("user_annotation", "fmov::chunk", 55 * US, 200 * US, 1)]

WANT_MS = {"pose": 0.010, "render": 0.020, "loss": 0.005, "backward": 0.034,
           "update": 0.004}


def _run(events, steps=2):
    return SimpleNamespace(trace=Trace(events, window_s=1e-3, steps=steps))


def _marked():
    return _run([_k("before_marks", 0, 3)] + _step(10) + _step(110) + HOST)


@pytest.mark.parametrize("phase", sorted(WANT_MS))
def test_phase_readers(phase):
    got = cells.reader(f"{phase}_ms_per_step")(_marked())
    assert got == pytest.approx(WANT_MS[phase], rel=1e-9)


def test_phases_close_to_busy():
    """The phases and the ops outside them make up the busy time."""
    run = _marked()
    split = phases.phase_seconds(run.trace)
    outside = (3 + 2 + 2) * US / 1e9
    marks = 2 * 6 * US / 1e9
    assert sum(split.values()) + outside + marks == pytest.approx(run.trace.busy_s, rel=1e-9)


def test_plan_reader():
    # plan_chunk 50 + 50, pack_rows 30 once however many categories hold it
    assert cells.reader("plan_ms_per_step")(_marked()) == pytest.approx(0.065, rel=1e-9)


@pytest.mark.parametrize("metric", sorted(f"{p}_ms_per_step" for p in WANT_MS)
                         + ["plan_ms_per_step"])
def test_readers_without_marks(metric):
    bare = [e for e in _step(10) if not e.name.startswith(phases.MARK)]
    for run in (_run(bare), _run(_step(10) + HOST, steps=0),
                SimpleNamespace(trace=None)):
        assert cells.reader(metric)(run) is None


@pytest.mark.parametrize("metric,span", [("capture_s", "fmov::capture"),
                                         ("runner_init_s", "fmov::runner_init")])
def test_span_readers(metric, span, monkeypatch):
    from fmov_pose_torch import tracing
    monkeypatch.setattr(tracing, "SPANS", {span: [2, 3.25], "fmov::chunk": [9, 1.0]})
    assert cells.reader(metric)(_marked()) == 3.25
    monkeypatch.setattr(tracing, "SPANS", {})
    assert cells.reader(metric)(_marked()) is None
