"""Program spans and device marks: where the port's time goes, by name.

``span(name)``: a host span, entered where work happens once a chunk or
once in set-up, never inside a step.  It is a
``torch.profiler.record_function`` range, so a running profiler records it
on the clock of its device trace, nested under its caller; it also adds
its count and host seconds to ``SPANS[name] = [count, seconds]``, the
process's own record, which readers outside a profiled window use (the
Runner logs it once at the end of training, ``summary``).  Without a
profiler it costs one ``record_function`` enter and exit and two clock
reads.  It works as a ``with`` block and as a decorator.

``mark(phase, like)``: a device mark, an empty kernel named
``fmov_mark_<phase>`` launched <<<1, 1>>> on the current stream of
``like``'s device (``ops/csrc/mark.cu``, built at first use).  A captured
CUDA graph holds it as a kernel node, so every replay runs it, and the
profiler's device trace shows the phase boundaries of every step, graphed
or eager, on its own clock (a ``record_function`` range is not replayed,
and a CUDA event, which is, does not appear in the trace).  The step
marks, in order, ``pose`` (frame poses and the ray batch), ``render``,
``loss``, ``backward``, ``update`` (the all-reduce of a data-parallel step
and the gated Adams) and ``end``.  On a CPU tensor it does nothing.

Span names: ``fmov::runner_init`` (child ``fmov::file_backup``),
``fmov::capture`` (child ``fmov::warmup``), ``fmov::chunk``,
``fmov::plan_chunk``, ``fmov::pack_rows``, ``fmov::events_after``,
``fmov::pro_events``, ``fmov::grid_refresh``, ``fmov::validate_mesh``,
``fmov::checkpoint``.
"""

from __future__ import annotations

import contextlib
import ctypes
import time

import torch

# name -> [count, host seconds], every span of the process
SPANS: dict = {}

PHASES = ("pose", "render", "loss", "backward", "update", "end")


@contextlib.contextmanager
def span(name: str):
    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        entry = SPANS.setdefault(name, [0, 0.0])
        entry[0] += 1
        entry[1] += time.perf_counter() - t0


def summary() -> str:
    """``SPANS`` as one line: each span's count and seconds, by name."""
    return " ".join(f"{name}={n}x{s:.3f}s" for name, (n, s) in sorted(SPANS.items()))


def _lib():
    from fmov_pose_torch.ops import build
    lib = build.library("mark")
    if not getattr(lib, "_fmov_typed", False):
        lib.fmov_mark.argtypes = [ctypes.c_int, ctypes.c_void_p]
        lib.fmov_mark.restype = ctypes.c_int
        lib.fmov_mark_error_string.argtypes = [ctypes.c_int]
        lib.fmov_mark_error_string.restype = ctypes.c_char_p
        lib._fmov_typed = True
    return lib


def mark(phase: str, like: torch.Tensor) -> None:
    """Launch the ``fmov_mark_<phase>`` kernel on the current stream of
    ``like``'s device; nothing on the CPU.  Raises on an unknown phase."""
    i = PHASES.index(phase)
    dev = like.device
    if dev.type != "cuda":
        return
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.fmov_mark(i, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"fmov_mark_{phase}: {lib.fmov_mark_error_string(err).decode()}")
