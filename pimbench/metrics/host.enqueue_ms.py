"""Host ms from a call's start to its return, before the synchronise: the
mean over the measured (untraced) window's calls."""


def read(run):
    if not run.calls:
        return None
    return sum(c.enqueue_s for c in run.calls) / len(run.calls) * 1e3
