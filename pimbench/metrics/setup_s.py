"""Seconds from the process's start to the measured window's start: imports,
the card, the input pool, the compile, the kernels' build on a checkout's
first run, and a warm-up call at every size."""


def read(run):
    return run.setup_s
