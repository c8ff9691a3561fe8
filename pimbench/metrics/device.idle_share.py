"""The share of the traced window in which nothing ran on the device: one
less the union of the device's busy intervals over the window, in %."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return (1 - run.trace.busy_s() / run.trace.window_s) * 100
