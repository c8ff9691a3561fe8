"""``elems_per_s`` in the cells of MAC waves, where the host sets the pace; read as
``elems_per_s`` is, under a name of its own so that these cells keep bounds and
metrics apart from the bulk cells'."""

from pimbench import spec

read = spec.reader("elems_per_s").read
