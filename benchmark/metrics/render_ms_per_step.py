"""``render_ms_per_step``: device ms a step of the render (``neus.render``:
the up-sampler, the fields, the compositing), from each step's
``fmov_mark_render`` to its ``fmov_mark_loss`` (``phases.phase_ms``: the
ops that start between the two marks, on any stream, the marks left out,
less a sub-phase marked between them, over the profiled sub-window's
steps). None without marks (a program without them, the CPU)."""

from benchmark import phases


def read(run):
    return phases.phase_ms(run, "render")
