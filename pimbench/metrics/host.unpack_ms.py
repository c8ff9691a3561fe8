"""Host ms a call inside the port's ``unpack.from_planes`` spans, in the
spans-only window (the profiler off)."""

from pimbench import attribution


def read(run):
    return attribution.reading(run, "host.unpack_ms")
