"""``plan_ms_per_step``: host ms a step in the planner, the spans
``fmov::plan_chunk`` (``Runner._plan_chunk``) and ``fmov::pack_rows``
(the chunk's rows stacked and copied to the device), their union in the
profiled sub-window over its steps (``phases.host_ms``).  None where the
window has neither (the scanned cells, a program without the spans)."""

from benchmark import phases


def read(run):
    return phases.host_ms(run, ("fmov::plan_chunk", "fmov::pack_rows"))
