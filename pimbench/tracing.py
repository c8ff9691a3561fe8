"""The traced window: the device's activity from ``torch.profiler`` and the
host's spans from the harness's own clock, on one timeline (Unix ns).

The profiler records device activity alone (kernels, copies and sets, and
the runtime calls that launch them), so host work is not slowed by tracing
every operator.  The host's spans come from the harness: each call's start,
return and synchronised end, and, inside the call, the layers of the port
the call enters (:data:`LAYER_SPANS`), timed by wrapping those entry points
for the traced window only.  The device's idle gaps are then named by what
the host was doing meanwhile.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import functools
import importlib
import re
import statistics
import time

# (module, class, method, span name): the port's layers a call enters.
LAYER_SPANS = (
    ("repro_torch.core.bitplanes", "PimType", "cast", "frontend.cast"),
    ("repro_torch.core.bitplanes", "PimType", "to_planes", "pack.to_planes"),
    ("repro_torch.pim.frontend", "CompiledPimFunction", "compiled", "frontend.compile_cache"),
    ("repro_torch.kernels.pim_bitserial", "CudaBackend", "run", "exec.run_schedule"),
    ("repro_torch.core.bitplanes", "PimType", "from_planes", "unpack.from_planes"),
)
# Host calls that put work on the device: launches, graph launches, copies, sets.
LAUNCH_CALL = re.compile(r"^cu(da)?(LaunchKernel|GraphLaunch|Memcpy|Memset)")
EXECUTOR_KERNEL = re.compile(r"bitserial")
# The host call each of the harness's synchronises makes.
SYNC_CALL = "cudaDeviceSynchronize"


@dataclasses.dataclass
class CallSpan:
    rows: int
    start: int  # ns
    returned: int
    end: int  # after the synchronise


@dataclasses.dataclass
class Trace:
    """What one traced window holds; times in Unix ns."""

    calls: list[CallSpan]
    device: list[tuple[str, int, int]]  # (name, start, end)
    launches: int  # host calls that launch device work
    spans: list[tuple[str, int, int]]  # the port's layers, host side
    offset_ns: int = 0  # the profiler's clock less the harness's

    @property
    def start(self) -> int:
        return self.calls[0].start

    @property
    def end(self) -> int:
        return self.calls[-1].end

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e9

    def device_s(self, name_filter=None) -> float:
        """Seconds of device activity (summed durations) in the window,
        of the events whose name ``name_filter`` accepts."""
        return sum(clip(s, e, self.start, self.end) for n, s, e in self.device
                   if name_filter is None or name_filter(n)) / 1e9

    def busy_s(self) -> float:
        """Seconds in which any device activity ran (the union)."""
        merged = merge([(s, e) for _, s, e in self.device])
        return sum(clip(s, e, self.start, self.end) for s, e in merged) / 1e9

    def idle_gaps(self) -> list[tuple[int, int]]:
        return gaps(merge([(s, e) for _, s, e in self.device]), self.start, self.end)


def clip(s: int, e: int, lo: int, hi: int) -> int:
    return max(0, min(e, hi) - max(s, lo))


def merge(intervals) -> list[tuple[int, int]]:
    """Sorted, non-overlapping union of ``(start, end)`` intervals."""
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def gaps(merged, lo: int, hi: int) -> list[tuple[int, int]]:
    """The stretches of ``[lo, hi]`` that no merged interval covers."""
    out, t = [], lo
    for s, e in merged:
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]


def host_segments(calls: list[CallSpan], spans) -> list[tuple[int, int, str]]:
    """The window cut into ``(start, end, what the host did)``: inside a
    call the innermost layer span, else ``frontend``; from a call's return to
    its end ``sync``; between calls ``harness``."""
    spans = sorted(spans, key=lambda x: x[1])
    out, j = [], 0
    for k, c in enumerate(calls):
        inside = []
        while j < len(spans) and spans[j][1] < c.returned:
            if spans[j][1] >= c.start:
                inside.append(spans[j])
            j += 1
        cuts = sorted({c.start, c.returned, *(t for _, s, e in inside for t in (s, e))})
        for s, e in zip(cuts, cuts[1:]):
            if s >= c.returned:
                break
            covering = [sp for sp in inside if sp[1] <= s and e <= sp[2]]
            label = min(covering, key=lambda sp: sp[2] - sp[1])[0] if covering else "frontend"
            out.append((s, e, label))
        out.append((c.returned, c.end, "sync"))
        if k + 1 < len(calls):
            out.append((c.end, calls[k + 1].start, "harness"))
    return out


def idle_by_host(trace: Trace) -> dict[str, float]:
    """Seconds of device idle time by what the host was doing meanwhile."""
    segments = host_segments(trace.calls, trace.spans)
    out: dict[str, float] = {}
    i = 0
    for gs, ge in trace.idle_gaps():
        while i < len(segments) and segments[i][1] <= gs:
            i += 1
        k = i
        while k < len(segments) and segments[k][0] < ge:
            s, e, label = segments[k]
            out[label] = out.get(label, 0.0) + clip(s, e, gs, ge) / 1e9
            k += 1
    return out


class Spans:
    """Host spans recorded by :func:`layer_spans`."""

    def __init__(self):
        self.items: list[tuple[str, int, int]] = []


def _timed(fn, name: str, spans: Spans):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        start = time.time_ns()
        try:
            return fn(*args, **kwargs)
        finally:
            spans.items.append((name, start, time.time_ns()))
    return wrapper


@contextlib.contextmanager
def layer_spans(spans: Spans):
    """Time the port's layer entry points into ``spans`` while inside; an
    entry point the port no longer has is left out."""
    saved = []
    try:
        for module, cls_name, method, name in LAYER_SPANS:
            try:
                cls = getattr(importlib.import_module(module), cls_name)
                fn = cls.__dict__[method]
            except (ImportError, AttributeError, KeyError):
                continue
            saved.append((cls, method, fn))
            setattr(cls, method, _timed(fn, name, spans))
        yield spans
    finally:
        for cls, method, fn in reversed(saved):
            setattr(cls, method, fn)


def _ns(event, which: str) -> int:
    getter = getattr(event, f"{which}_ns", None)
    if getter is not None:
        return int(getter())
    return int(getattr(event, f"{which}_us")() * 1000)


def clock_offset(call_ends: list[int], sync_ends: list[int]) -> int:
    """The profiler's clock less the harness's: the median, over the calls,
    of the gap from a call's end to the end of its device synchronise (each
    call ends in one), matched in order, or else the nearest; 0 without."""
    if not sync_ends:
        return 0
    sync_ends = sorted(sync_ends)
    if len(sync_ends) == len(call_ends):
        return int(statistics.median(s - e for s, e in zip(sync_ends, call_ends)))
    diffs = []
    for end in call_ends:
        k = bisect.bisect_left(sync_ends, end)
        near = [sync_ends[j] for j in (k - 1, k) if 0 <= j < len(sync_ends)]
        diffs.append(min(near, key=lambda t: abs(t - end)) - end)
    return int(statistics.median(diffs))


def read_profile(prof, calls: list[CallSpan], spans: Spans) -> Trace:
    """The device events and launch calls of a finished ``torch.profiler``
    run, moved onto the harness's timeline by :func:`clock_offset`."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = _ns(e, "start")
        item = (e.name(), start, start + _ns(e, "duration"))
        (device if e.device_type() == DeviceType.CUDA else host).append(item)
    offset = clock_offset([c.end for c in calls],
                          [end for name, _, end in host if name == SYNC_CALL])
    lo, hi = calls[0].start + offset, calls[-1].end + offset
    launches = sum(1 for name, start, _ in host if LAUNCH_CALL.match(name) and lo <= start <= hi)
    return Trace(calls=calls, device=[(n, s - offset, e - offset) for n, s, e in device],
                 launches=launches, spans=list(spans.items), offset_ns=offset)
