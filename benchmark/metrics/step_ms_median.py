"""``step_ms_median``: the median time of a training step in the window,
from the Runner's own CUDA events between chunks (``Runner.step_ms``: a
chunk's time over its steps)."""

import statistics


def read(run):
    return statistics.median(run.step_ms) if run.step_ms else None
