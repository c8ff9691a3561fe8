"""Device ms a call in the executor's kernels (the loop kernel and the
generated straight-line kernels, by name), from the traced window."""

from pimbench.tracing import EXECUTOR_KERNEL


def read(run):
    if run.trace is None:
        return None
    ms = run.trace.device_s(lambda name: bool(EXECUTOR_KERNEL.search(name))) * 1e3
    return ms / len(run.trace.calls) if ms > 0 else None
