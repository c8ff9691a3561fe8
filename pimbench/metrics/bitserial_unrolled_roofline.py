"""The straight-line kernels' share of their roofline: the frozen kernel
bound of the traced calls over the generated segment kernels' device time,
in %."""

import re

from pimbench import roofline

KERNEL = re.compile(r"bitserial_seg\d")


def read(run):
    return roofline.kernel_share(run, lambda name: bool(KERNEL.search(name)))
