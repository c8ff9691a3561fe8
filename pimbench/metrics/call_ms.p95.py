"""The 95th percentile of the measured window's call times (start to the
synchronised end, host clock), in ms."""

import numpy as np


def read(run):
    if not run.calls:
        return None
    return float(np.percentile([c.seconds for c in run.calls], 95)) * 1e3
