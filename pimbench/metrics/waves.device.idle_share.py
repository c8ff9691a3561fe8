"""``device.idle_share`` in the cells of MAC waves, where the host sets the pace; read as
``device.idle_share`` is, under a name of its own so that these cells keep bounds and
metrics apart from the bulk cells'."""

from pimbench import spec

read = spec.reader("device.idle_share").read
