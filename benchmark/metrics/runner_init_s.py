"""``runner_init_s``: host seconds of ``Runner.__init__`` (span
``fmov::runner_init``: the conf, the scene to the device, the fields' and
pose nets' host init, the step closures, the source backup), from
``tracing.SPANS`` once ``Runner.train()`` has returned.  None where the
program keeps no such table."""

from benchmark import phases


def read(run):
    return phases.span_seconds("fmov::runner_init")
