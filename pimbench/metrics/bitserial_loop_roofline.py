"""The loop kernel's share of its roofline: the frozen kernel bound of the
traced calls over the loop kernel's device time, in %."""

from pimbench import roofline

KERNEL = "bitserial_loop"


def read(run):
    return roofline.kernel_share(run, lambda name: KERNEL in name)
