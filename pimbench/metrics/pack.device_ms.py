"""Device ms a call in everything that is not the executor's kernels
(packing, unpacking, copies and sets), from the traced window."""

from pimbench.tracing import EXECUTOR_KERNEL


def read(run):
    if run.trace is None:
        return None
    ms = run.trace.device_s(lambda name: not EXECUTOR_KERNEL.search(name)) * 1e3
    return ms / len(run.trace.calls)
