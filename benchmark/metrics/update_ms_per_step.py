"""``update_ms_per_step``: device ms a step of the update (a data-parallel
step's all-reduce, the gated Adams), from each step's
``fmov_mark_update`` to its ``fmov_mark_end`` (``phases.phase_ms``: the
ops that start between the two marks, on any stream, the marks left out,
over the profiled sub-window's steps). None without marks (a program
without them, the CPU)."""

from benchmark import phases


def read(run):
    return phases.phase_ms(run, "update")
