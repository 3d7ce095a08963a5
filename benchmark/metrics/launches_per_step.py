"""``launches_per_step``: device kernels in the profiled sub-window over
its training steps (a captured step's kernels count each replay)."""


def read(run):
    if not run.trace.kernels or not run.trace.steps:
        return None
    return len(run.trace.kernels) / run.trace.steps
