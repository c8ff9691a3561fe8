"""Simulated rows a second: the rows of every call completed in the measured
window over the window's seconds, on the host clock."""


def read(run):
    if not run.calls or run.window_s <= 0:
        return None
    return sum(c.rows for c in run.calls) / run.window_s
