"""The traced window: the device's activity from ``torch.profiler`` and the
host's spans from the port itself, on one timeline (Unix ns).

The profiler records device activity alone (kernels, copies and sets, and
the runtime calls that launch them), so host work is not slowed by tracing
every operator.  The host's spans are the harness's (each call's start,
return and synchronised end) and the port's own (``repro_torch.core.spans``,
recorded while the window runs).  Both the port's spans and the profiler's
host events are stamped on ``time.time_ns()``, so the two are put on one
timeline with no offset.  The device's idle gaps are then named by what the
host was doing meanwhile.
"""

from __future__ import annotations

import dataclasses
import re

# Host calls that put work on the device: launches, graph launches, copies, sets.
LAUNCH_CALL = re.compile(r"^cu(da)?(LaunchKernel|GraphLaunch|Memcpy|Memset)")
EXECUTOR_KERNEL = re.compile(r"bitserial")
# The port's span of a whole call: its self time is the idle gaps' ``frontend``.
CALL_SPAN = "pim.call"


@dataclasses.dataclass
class CallSpan:
    rows: int
    start: int  # ns
    returned: int
    end: int  # after the synchronise


@dataclasses.dataclass
class Trace:
    """What one traced window holds; times in Unix ns.  An event is
    ``(name, start, end, correlation id)``: a device event carries the id of
    the runtime call that launched it."""

    calls: list[CallSpan]
    device: list[tuple[str, int, int, int]]
    host: list[tuple[str, int, int, int]]  # the runtime calls
    launches: int  # host calls in the window that launch device work
    spans: list[tuple[str, int, int]]  # the port's closed spans but the call's own

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
        return sum(clip(s, e, self.start, self.end) for n, s, e, _ in self.device
                   if name_filter is None or name_filter(n)) / 1e9

    def busy_s(self) -> float:
        """Seconds in which any device activity ran (the union)."""
        merged = merge([(s, e) for _, s, e, _ in self.device])
        return sum(clip(s, e, self.start, self.end) for s, e in merged) / 1e9

    def idle_gaps(self) -> list[tuple[int, int]]:
        return gaps(merge([(s, e) for _, s, e, _ in self.device]), self.start, self.end)


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
    call the innermost span, else ``frontend``; from a call's return to its
    end ``sync``; between calls ``harness``."""
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


def _ns(event, which: str) -> int:
    getter = getattr(event, f"{which}_ns", None)
    if getter is not None:
        return int(getter())
    return int(getattr(event, f"{which}_us")() * 1000)


def read_profile(prof, calls: list[CallSpan], recorded) -> Trace:
    """The device events and host runtime calls of a finished
    ``torch.profiler`` run, with their correlation ids, beside the port's
    spans ``recorded`` in the same window."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = _ns(e, "start")
        item = (e.name(), start, start + _ns(e, "duration"), e.correlation_id())
        (device if e.device_type() == DeviceType.CUDA else host).append(item)
    lo, hi = calls[0].start, calls[-1].end
    launches = sum(1 for name, start, _, _ in host if LAUNCH_CALL.match(name) and lo <= start <= hi)
    spans = [(s.name, s.start_ns, s.end_ns) for s in recorded
             if s.name != CALL_SPAN and s.end_ns is not None]
    return Trace(calls=calls, device=device, host=host, launches=launches, spans=spans)
