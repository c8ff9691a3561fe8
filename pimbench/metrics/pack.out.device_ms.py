"""Device ms a call of the operations launched by packing's output side: those
whose launch call lies inside the port's ``unpack.from_planes`` spans,
matched by correlation id in the profiled window."""

from pimbench import attribution


def read(run):
    return attribution.reading(run, "pack.out.device_ms")
