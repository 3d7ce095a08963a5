"""``capture_s``: host seconds of the run's captures of the training step
(span ``fmov::capture``: ``StepGraph``'s eager warm-up steps and the
capture), all the run's, from ``tracing.SPANS`` once ``Runner.train()``
has returned; a capture inside the window counts too.  None where
nothing was captured (the CPU) or the program keeps no such table."""

from benchmark import phases


def read(run):
    return phases.span_seconds("fmov::capture")
