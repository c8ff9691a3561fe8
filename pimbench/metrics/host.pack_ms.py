"""Host ms a call inside the port's ``frontend.cast``, ``pack.to_planes`` and
``pack.stack`` spans, in the spans-only window (the profiler off)."""

from pimbench import attribution


def read(run):
    return attribution.reading(run, "host.pack_ms")
