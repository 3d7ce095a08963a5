"""``pose_ms_per_step``: device ms a step of the frame poses and the ray
batch, from each step's ``fmov_mark_pose`` to its ``fmov_mark_render``
(``phases.phase_ms``: the ops that start between the two marks, on any
stream, the marks left out, over the profiled sub-window's steps). None
without marks (a program without them, the CPU)."""

from benchmark import phases


def read(run):
    return phases.phase_ms(run, "pose")
