"""``call_ms.p95`` in the cells of MAC waves, where the host sets the pace; read as
``call_ms.p95`` is, under a name of its own so that these cells keep bounds and
metrics apart from the bulk cells'."""

from pimbench import spec

read = spec.reader("call_ms.p95").read
