"""``device_idle_share``: the share of the profiled sub-window in which
no kernel, copy or set ran on the device (1 - the union of their
intervals over the sub-window, on the host clock between two
synchronisations), in %."""


def read(run):
    if not run.trace.device or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
