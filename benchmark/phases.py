"""What the program's own tracing (``fmov_pose_torch/tracing.py``) gives
the per-layer readers: a step's device time split at its marks, host
spans in the profiled sub-window, and the process's table of spans.

* ``phase_ms``: the step marks (kernels named ``fmov_mark_<phase>``, in
  captured graphs too) split the device's ops; an op (kernel, copy or
  set) belongs to the phase of the last mark that started before it,
  whatever the mark's name, on any stream, so a stage that a kernel
  launches on another stream counts with it; ops after ``end`` and before
  the next mark belong to none.  Each step marks ``PHASES`` and ``end``;
  a mark of another name opens a phase of its own (a sub-phase, such as
  a background's forward inside the render, read by its name), and a
  program that marks ``render`` again after such a sub-phase keeps the
  rest of its render in ``render``.  A phase's time is the union of its
  ops' intervals (what ``Trace.busy_s`` counts, the marks left out), in
  ms over the sub-window's steps.
* ``host_ms``: the union of the host events of the given names (any host
  category), in ms over the sub-window's steps.
* ``span_seconds``: a span's seconds in ``tracing.SPANS``, the whole
  run's, read after ``Runner.train()``.

Each returns None where it has nothing to read: no marks, a sub-phase
that no mark opened, no such event, no such span, or a program without
``tracing``.
"""

from __future__ import annotations

from benchmark import trace as trace_mod

MARK = "fmov_mark_"
PHASES = ("pose", "render", "loss", "backward", "update")  # every step marks these
END = "end"  # closes a step: its ops belong to no phase


def _union_s(intervals) -> float:
    """Seconds of the union of (start, end) ns intervals."""
    total, cur = 0, None
    for a, b in sorted(intervals):
        if cur and a <= cur[1]:
            cur[1] = max(cur[1], b)
        else:
            if cur:
                total += cur[1] - cur[0]
            cur = [a, b]
    if cur:
        total += cur[1] - cur[0]
    return total / 1e9


def phase_seconds(tr):
    """{phase: device seconds} over the sub-window, or None without marks:
    every phase a mark opened, and ``PHASES`` always (0 where empty)."""
    spans, phase, marks = {p: [] for p in PHASES}, None, 0
    for e in tr.device:
        name = trace_mod.short(e.name) if e.cat == "kernel" else ""
        if name.startswith(MARK):
            marks += 1
            phase = name[len(MARK):]
        elif phase is not None and phase != END:
            spans.setdefault(phase, []).append((e.start_ns, e.start_ns + e.dur_ns))
    if not marks:
        return None
    return {p: _union_s(iv) for p, iv in spans.items()}


def phase_ms(run, phase: str):
    """Device ms a step of ``phase`` in the profiled sub-window, or None
    (also for a sub-phase that no mark opened)."""
    tr = run.trace
    if tr is None or not tr.steps:
        return None
    split = phase_seconds(tr)
    if split is None or phase not in split:
        return None
    return split[phase] * 1e3 / tr.steps


def host_ms(run, names):
    """Host ms a step of the events named ``names`` in the profiled
    sub-window (their union, once however they nest), or None."""
    tr = run.trace
    if tr is None or not tr.steps:
        return None
    iv = [(e.start_ns, e.start_ns + e.dur_ns) for e in tr.host if e.name in names]
    return _union_s(iv) * 1e3 / tr.steps if iv else None


def span_seconds(name: str):
    """``tracing.SPANS[name]``'s seconds in this process, or None."""
    try:
        from fmov_pose_torch import tracing
    except ImportError:
        return None
    entry = tracing.SPANS.get(name)
    return float(entry[1]) if entry else None
