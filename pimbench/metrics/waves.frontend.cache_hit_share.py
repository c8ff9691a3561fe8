"""``frontend.cache_hit_share`` in the cells of MAC waves, where the host sets the pace; read as
``frontend.cache_hit_share`` is, under a name of its own so that these cells keep bounds and
metrics apart from the bulk cells'."""

from pimbench import spec

read = spec.reader("frontend.cache_hit_share").read
