"""``torch.cuda.max_memory_allocated()`` over the measured window (its
statistics reset when the window opens), in GiB."""


def read(run):
    return None if run.peak_bytes is None else run.peak_bytes / (1 << 30)
