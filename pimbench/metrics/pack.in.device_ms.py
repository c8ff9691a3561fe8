"""Device ms a call of the operations launched by packing's input side: those
whose launch call lies inside the port's ``frontend.cast``, ``pack.to_planes``
or ``pack.stack`` spans, matched by correlation id in the profiled window."""

from pimbench import attribution


def read(run):
    return attribution.reading(run, "pack.in.device_ms")
