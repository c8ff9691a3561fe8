"""``host.launches_per_call`` in the cells of MAC waves, where the host sets the pace; read as
``host.launches_per_call`` is, under a name of its own so that these cells keep bounds and
metrics apart from the bulk cells'."""

from pimbench import spec

read = spec.reader("host.launches_per_call").read
