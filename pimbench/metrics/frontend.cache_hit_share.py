"""The share of the traced windows' calls, in %, that hit every cache: whose
``pim.call`` span holds no ``ir.compile`` or ``exec.build`` span."""

from pimbench import attribution


def read(run):
    return attribution.reading(run, "frontend.cache_hit_share")
