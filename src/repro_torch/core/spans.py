"""Spans and counters at the port's layer boundaries, kept in memory.

A span is a named stretch of host time, opened and closed by a ``with``
statement: ``with span("pack.to_planes"): ...``.  While :func:`recording`
is active, each span appends one :class:`Span` to the recording's list:
``(name, start_ns, end_ns, parent, call_id, attrs)``.  Times are
``time.time_ns()``, the clock on which ``torch.profiler`` stamps host
events, so a launch the profiler records falls inside the span that made it
with no offset applied.  ``parent`` is the list index of the enclosing span
(None at the top); a top-level span takes a new ``call_id`` and the spans
inside it share it, so the spans of one ``pim.compile`` call share one.
Spans are recorded from one thread at a time.

Recording is off by default.  Then :func:`span` tests one flag and returns
one shared object that does nothing: no clock read, no record.

Counters are always on: :func:`count` adds into one dict, :func:`counters`
reads it and :func:`reset_counters` clears it.  :class:`CounterView` gives
some counters a dict's interface under names of their own (the executors'
``LAUNCHES``, the compile cache's ``cache_stats()``).

Spans and counters of the main path (``pim.compile(fn, dtype)(...)``):

=======================  ==================================================
span                     what it covers
=======================  ==================================================
``pim.call``             the whole call (attrs ``dtype``, ``basis``, ``rows``)
``frontend.cast``        ``PimType.cast`` of one argument
``pack.to_planes``       ``PimType.to_planes`` of one argument
``pack.stack``           the ``torch.stack`` of every input plane
``frontend.compile_cache``  the compile-cache lookup
``ir.compile``           a compile on a cache miss
``exec.run_schedule``    the executor: registration, padding, dispatch
``exec.launch``          the kernel launch calls
``exec.build``           a library build or load, a segment generation or a
                         gate-table upload, on a miss (attr ``what``)
``unpack.from_planes``   ``PimType.from_planes`` of one output
=======================  ==================================================

Counters: ``ir.compile.hits`` and ``ir.compile.misses`` (read by
``ir.cache_stats()``), and one launch count a kernel,
``exec.launches.bitserial_loop``, ``exec.launches.bitserial_unrolled`` and
``exec.launches.mm_<variant>`` (read by each executor's ``LAUNCHES``).
A cache miss of the executor is its ``exec.build`` span, not a counter.
"""

from __future__ import annotations

import collections
import contextlib
import time
from collections.abc import Iterator, Mapping
from typing import Any, NamedTuple


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int | None  # None while the span is open
    parent: int | None  # index of the enclosing span in the recording
    call_id: int
    attrs: dict[str, Any]


_recording: list[Span] | None = None  # the active recording, None when off
_open: list[int] = []  # indices of the open spans, innermost last
_next_call = 0

_counts: collections.defaultdict[str, int] = collections.defaultdict(int)


class _Off:
    """What :func:`span` returns while recording is off."""

    __slots__ = ()

    def __enter__(self) -> _Off:
        return self

    def __exit__(self, *exc) -> None:
        return None

    def set(self, key: str, value: Any) -> None:
        pass


_OFF = _Off()


class _Live:
    """A span being recorded."""

    __slots__ = ("name", "attrs", "index", "out", "stack")

    def __init__(self, name: str, attrs: dict[str, Any]):
        self.name, self.attrs = name, attrs

    def __enter__(self) -> _Live:
        global _next_call
        out, stack = self.out, self.stack = _recording, _open
        parent = stack[-1] if stack else None
        if parent is None:
            call_id, _next_call = _next_call, _next_call + 1
        else:
            call_id = out[parent].call_id
        self.index = len(out)
        out.append(Span(self.name, time.time_ns(), None, parent, call_id, self.attrs))
        stack.append(self.index)
        return self

    def __exit__(self, *exc) -> None:
        end = time.time_ns()
        self.stack.pop()
        self.out[self.index] = self.out[self.index]._replace(end_ns=end)

    def set(self, key: str, value: Any) -> None:
        """Add an attribute once its value is known inside the span."""
        self.attrs[key] = value


def span(name: str, **attrs):
    """A context manager that records ``name`` from entry to exit while
    recording is on, and does nothing otherwise.  The object it yields
    takes further attributes with ``.set(key, value)``."""
    if _recording is None:
        return _OFF
    return _Live(name, attrs)


@contextlib.contextmanager
def recording() -> Iterator[list[Span]]:
    """Record spans while inside; yields the list they are appended to.
    Recordings do not nest."""
    global _recording, _open, _next_call
    if _recording is not None:
        raise RuntimeError("spans are already being recorded")
    _recording, _open, _next_call = [], [], 0
    try:
        yield _recording
    finally:
        _recording, _open = None, []


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name``."""
    _counts[name] += n


def counters(prefix: str = "") -> dict[str, int]:
    """The counters whose names start with ``prefix``, by name."""
    return {k: v for k, v in _counts.items() if k.startswith(prefix)}


def reset_counters(prefix: str = "") -> None:
    """Clear the counters whose names start with ``prefix`` (all by default)."""
    for k in [k for k in _counts if k.startswith(prefix)]:
        del _counts[k]


class CounterView(Mapping):
    """A read-only dict of counters under names of its own:
    ``CounterView({"hits": "ir.compile.hits"})["hits"]`` reads that counter."""

    def __init__(self, names: dict[str, str]):
        self._names = dict(names)

    def __getitem__(self, key: str) -> int:
        return _counts.get(self._names[key], 0)

    def __iter__(self):
        return iter(self._names)

    def __len__(self) -> int:
        return len(self._names)

    def __repr__(self) -> str:
        return repr(dict(self))
