"""The one traffic generator: a closed loop of calls whose rows follow a
frozen table of ``[rows, weight]`` pairs.

The order is a smooth weighted round robin over the table (each step picks
the entry furthest behind its share), so every stretch of calls holds each
size in its share to within two calls; the seed picks where in that period
the run starts.  Every seed thus sends the same mix of work in a window,
and a run's spread is the system's, not the draw's.  Call ``i`` takes the
first rows of pool set ``i % pool_sets``.  A traffic file's ``cpu_rows`` is
the same table in the cell's own shape and weights, with sizes of at most
1024 rows, for the CPU tests; a run on the card never reads it.

The correctness check keeps ``check_per_size`` results of every size the
window sends, each a uniform draw over all the window's calls of that size
(reservoir sampling, from the seed): every size is checked, and a call late
in the window is as likely to be as an early one.
"""

from __future__ import annotations

import numpy as np


def smooth_order(table: list[list[int]]) -> np.ndarray:
    """One period (``sum(weights)`` calls) of rows in smooth round robin."""
    rows = [int(r) for r, _ in table]
    weights = [int(w) for _, w in table]
    if any(r < 1 for r in rows) or any(w < 1 for w in weights):
        raise ValueError(f"rows and weights must be positive: {table!r}")
    total = sum(weights)
    current = [0] * len(rows)
    order = np.empty(total, dtype=np.int64)
    for step in range(total):
        for j, w in enumerate(weights):
            current[j] += w
        pick = max(range(len(rows)), key=current.__getitem__)
        current[pick] -= total
        order[step] = rows[pick]
    return order


class Calls:
    """The rows and pool set of every call a run makes, from its seed, and
    which results the correctness check keeps."""

    def __init__(self, traffic: dict, seed: int):
        self.order = smooth_order(traffic["rows"])
        self.sets = int(traffic["pool_sets"])
        self.per_size = int(traffic["check_per_size"])
        self._rng = np.random.default_rng(seed)
        self.offset = int(self._rng.integers(len(self.order)))
        self.seen: dict[int, int] = {}  # the window's calls of each size so far

    def rows(self, i: int) -> int:
        return int(self.order[(self.offset + i) % len(self.order)])

    def pool_set(self, i: int) -> int:
        return i % self.sets

    def keep_slot(self, rows: int) -> int | None:
        """The slot, of this size's ``check_per_size``, that the result of
        the window's next call of ``rows`` rows takes, or None when it is not
        kept.  Of the ``n`` calls of a size, each ends up kept with the same
        chance, ``check_per_size / n``."""
        n = self.seen[rows] = self.seen.get(rows, 0) + 1
        if n <= self.per_size:
            return n - 1
        j = int(self._rng.integers(n))
        return j if j < self.per_size else None

    @property
    def sizes(self) -> list[int]:
        """The distinct rows, largest first (the shapes to warm up)."""
        return sorted({int(r) for r in self.order}, reverse=True)
