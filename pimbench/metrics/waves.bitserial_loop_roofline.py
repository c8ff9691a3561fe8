"""``bitserial_loop_roofline`` in the cells of MAC waves, where the host sets the pace; read as
``bitserial_loop_roofline`` is, under a name of its own so that these cells keep bounds and
metrics apart from the bulk cells'."""

from pimbench import spec

read = spec.reader("bitserial_loop_roofline").read
