"""Host calls that put work on the device (kernel and graph launches,
copies, sets) a call, counted by the profiler in the traced window."""


def read(run):
    if run.trace is None:
        return None
    return run.trace.launches / len(run.trace.calls)
