"""The whole call's share of the chip's peak: the frozen least time of the
measured window's calls (``roofline.call_bound_s``) over the window, in %.
Read from the untraced window, so the profiler's cost to the host does not
enter it."""

from pimbench import roofline


def read(run):
    if not run.calls or run.peak is None or run.window_s <= 0:
        return None
    least = sum(roofline.call_bound_s(run.cell.work, run.cell.program["row_bytes"], c.rows,
                                      run.peak)[0] for c in run.calls)
    return least / run.window_s * 100
