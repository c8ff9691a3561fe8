"""The port's own spans joined to a ``torch.profiler`` trace: which layer of
the port launched each device operation, and each layer's host time.

The port records spans at its layer boundaries (``repro_torch.core.spans``)
on ``time.time_ns()``, the clock on which the profiler stamps host events.
Every device event (kernel, copy, set) carries the correlation id of the
runtime call that launched it.  A device event's time goes to the innermost
port span that holds its launch call; one whose launch call is missing from
the trace or lies in no span is ``unattributed``.

A traced run would measure three windows: the untraced one the harness
times; a spans-only window (:func:`spans_window`: spans on, profiler off),
whose host times carry no profiler cost; and the profiled window
(:func:`profiled_window`: both on), whose device time :func:`attribute`
splits by the span that launched it.  ``pimbench/spans_probe.py`` runs the
three on a cell and prints what :func:`layer_readings` and :func:`checks`
read from them.
"""

from __future__ import annotations

import bisect
import dataclasses
import time
import types

from repro_torch.core import spans as port_spans

from . import spec, tracing

UNATTRIBUTED = "unattributed"
# The spans whose launches are the input side of packing, and the output side.
PACK_IN = ("frontend.cast", "pack.to_planes", "pack.stack")
PACK_OUT = ("unpack.from_planes",)
# Spans inside a call that mark a cache miss: a compile, a library build or
# load, a segment generation, a gate-table upload.
COLD = ("ir.compile", "exec.build")
CALL = "pim.call"
LAUNCH = "exec.launch"


@dataclasses.dataclass
class Profile:
    """A profiler run's events with their correlation ids, on the
    profiler's clock (Unix ns)."""

    device: list[tuple[str, int, int, int]]  # (name, start, end, correlation id)
    host: list[tuple[str, int, int, int]]  # the runtime calls, the same fields


def read_events(prof) -> Profile:
    """The device events and host runtime calls of a finished profiler run."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = tracing._ns(e, "start")
        item = (e.name(), start, start + tracing._ns(e, "duration"), e.correlation_id())
        (device if e.device_type() == DeviceType.CUDA else host).append(item)
    return Profile(device=device, host=host)


class SpanIndex:
    """Finds the innermost closed span that holds an interval.  Spans of one
    recording nest, and their list is in order of start, so the innermost
    span holding ``[lo, hi]`` is the last span to start at or before ``lo``
    or one of its ancestors."""

    def __init__(self, recorded: list[port_spans.Span]):
        self.spans = recorded
        self.starts = [s.start_ns for s in recorded]

    def innermost(self, lo: int, hi: int) -> int | None:
        k = bisect.bisect_right(self.starts, lo) - 1
        while k is not None and k >= 0:
            s = self.spans[k]
            if s.end_ns is not None and hi <= s.end_ns:
                return k
            k = s.parent
        return None

    def name(self, lo: int, hi: int) -> str:
        k = self.innermost(lo, hi)
        return UNATTRIBUTED if k is None else self.spans[k].name


def _launcher(profile: Profile, index: SpanIndex, host_offset_ns: int):
    """correlation id -> the name of the innermost span that holds the host
    call with that id, at its profiler time less ``host_offset_ns``."""
    runtime = {c: (s, e) for _, s, e, c in profile.host if c}

    def where(corr: int) -> str:
        call = runtime.get(corr) if corr else None
        if call is None:
            return UNATTRIBUTED
        return index.name(call[0] - host_offset_ns, call[1] - host_offset_ns)
    return where


@dataclasses.dataclass
class Attribution:
    """Device time and host launch calls of the profiled window, by the
    name of the innermost port span that launched them."""

    device_ns: dict[str, int]  # every device event, clipped to the window
    executor_ns: dict[str, int]  # the executor's kernels alone
    launches: dict[str, int]  # host calls that launch device work
    executor_in_launch: int  # executor kernels launched inside an ``exec.launch`` span
    executor_kernels: int
    calls: int

    def ms_a_call(self, names) -> float:
        """Device ms a call launched inside the spans ``names``."""
        return sum(self.device_ns.get(n, 0) for n in names) / self.calls / 1e6


def attribute(profile: Profile, recorded: list[port_spans.Span], trace: tracing.Trace,
              host_offset_ns: int = 0) -> Attribution:
    """Split ``trace``'s window by the port's spans.  Device events are
    clipped to the window as ``trace`` clips them (moved by its offset), so
    the parts sum to the trace's device time.  A launch call is matched to
    the spans at its profiler time less ``host_offset_ns``: 0 where the
    profiler's host clock is ``time.time_ns()``."""
    index = SpanIndex(recorded)
    launcher = _launcher(profile, index, host_offset_ns)
    device_ns: dict[str, int] = {}
    executor_ns: dict[str, int] = {}
    inside = total = 0
    for name, s, e, corr in profile.device:
        ns = tracing.clip(s - trace.offset_ns, e - trace.offset_ns, trace.start, trace.end)
        where = launcher(corr)
        device_ns[where] = device_ns.get(where, 0) + ns
        if tracing.EXECUTOR_KERNEL.search(name):
            executor_ns[where] = executor_ns.get(where, 0) + ns
            if ns:
                total += 1
                inside += where == LAUNCH
    lo, hi = trace.start + trace.offset_ns, trace.end + trace.offset_ns
    launches: dict[str, int] = {}
    for name, s, e, _ in profile.host:
        if tracing.LAUNCH_CALL.match(name) and lo <= s <= hi:
            where = index.name(s - host_offset_ns, e - host_offset_ns)
            launches[where] = launches.get(where, 0) + 1
    return Attribution(device_ns=device_ns, executor_ns=executor_ns, launches=launches,
                       executor_in_launch=inside, executor_kernels=total,
                       calls=len(trace.calls))


def host_ms(recorded: list[port_spans.Span], names) -> float | None:
    """Host ms a call inside the spans ``names`` (which do not nest in one
    another), over the recording's ``pim.call`` spans."""
    calls = sum(1 for s in recorded if s.name == CALL)
    if not calls:
        return None
    return sum(s.end_ns - s.start_ns for s in recorded
               if s.name in names and s.end_ns is not None) / calls / 1e6


def cache_hit_share(*recordings: list[port_spans.Span]) -> float | None:
    """The share of ``pim.call`` spans, in %, whose call made no compile,
    build or table upload (no ``ir.compile`` or ``exec.build`` span)."""
    calls = cold = 0
    for recorded in recordings:
        ids = {s.call_id for s in recorded if s.name == CALL}
        calls += len(ids)
        cold += len({s.call_id for s in recorded if s.name in COLD} & ids)
    return None if not calls else (calls - cold) / calls * 100


def layer_spans(recorded: list[port_spans.Span]) -> tracing.Spans:
    """The port's spans under the names the breakdown's idle gaps use; a
    call's own span is left out, so its self time reads ``frontend``."""
    out = tracing.Spans()
    out.items = [(s.name, s.start_ns, s.end_ns) for s in recorded
                 if s.name != CALL and s.end_ns is not None]
    return out


def spans_window(session, first: int, max_calls: int, seconds: float):
    """``max_calls`` calls with the port's spans on and the profiler off;
    returns the calls' ``(rows, start, returned, end)``, the failures and
    the spans."""
    with port_spans.recording() as recorded:
        calls, failures = session.drive(first, seconds, time.time_ns, max_calls=max_calls)
    return calls, failures, recorded


def profiled_window(session, first: int, max_calls: int, seconds: float):
    """The same calls with the spans on under ``torch.profiler`` (device
    activity only; on the CPU, the host's ops); returns the calls, the
    failures, the spans and the finished profiler."""
    from torch.profiler import ProfilerActivity, profile

    activity = ProfilerActivity.CUDA if session.device.type == "cuda" else ProfilerActivity.CPU
    with port_spans.recording() as recorded, profile(activities=[activity]) as prof:
        calls, failures = session.drive(first, seconds, time.time_ns, max_calls=max_calls)
    return calls, failures, recorded, prof


def layer_readings(attr: Attribution, spans_only: list[port_spans.Span],
                   profiled: list[port_spans.Span]) -> dict[str, float | None]:
    """What the five per-layer metrics would read: device ms a call launched
    by packing's input and output sides (profiled window), host ms a call in
    them (spans-only window), and the share of calls that hit every cache."""
    return {
        "pack.in.device_ms": attr.ms_a_call(PACK_IN),
        "pack.out.device_ms": attr.ms_a_call(PACK_OUT),
        "host.pack_ms": host_ms(spans_only, PACK_IN),
        "host.unpack_ms": host_ms(spans_only, PACK_OUT),
        "frontend.cache_hit_share": cache_hit_share(spans_only, profiled),
    }


def _read(metric: str, trace: tracing.Trace) -> float | None:
    return spec.reader(metric).read(types.SimpleNamespace(trace=trace))


def checks(attr: Attribution, trace: tracing.Trace) -> dict[str, dict]:
    """The attribution against the trace's own readings, each ``value``
    beside what it should equal (``of``):

    * packing's two sides and the rest (the other non-executor device time,
      attributed elsewhere or not at all) sum to ``pack.device_ms``;
    * the device time attributed to ``exec.launch`` is ``exec.device_ms``;
    * every executor kernel was launched inside an ``exec.launch`` span;
    * the launch calls by span sum to ``host.launches_per_call``."""
    rest_ns = sum(v - attr.executor_ns.get(k, 0) for k, v in attr.device_ns.items()
                  if k not in PACK_IN + PACK_OUT)
    rest = rest_ns / attr.calls / 1e6
    by_span = {k: v / attr.calls for k, v in sorted(attr.launches.items())}
    return {
        "pack_parts_ms": {"value": attr.ms_a_call(PACK_IN) + attr.ms_a_call(PACK_OUT) + rest,
                          "of": _read("pack.device_ms", trace), "rest": rest},
        "exec_launch_ms": {"value": attr.ms_a_call([LAUNCH]),
                           "of": _read("exec.device_ms", trace) or 0.0},
        "executor_in_launch": {"value": attr.executor_in_launch, "of": attr.executor_kernels},
        "launches_by_span": {"value": sum(by_span.values()), "by_span": by_span,
                             "of": _read("host.launches_per_call", trace)},
    }


def within(value: float, of: float, share: float = 0.01) -> bool:
    return abs(value - of) <= share * abs(of)


def at_offset(trace: tracing.Trace, offset_ns: int) -> tracing.Trace:
    """``trace`` with its device events placed by another clock offset."""
    move = trace.offset_ns - offset_ns
    return dataclasses.replace(trace, offset_ns=offset_ns,
                               device=[(n, s + move, e + move) for n, s, e in trace.device])


def sync_idle(profile: Profile, recorded: list[port_spans.Span], trace: tracing.Trace,
              host_offset_ns: int = 0) -> dict[str, list[float]]:
    """Device idle time while the host waits in the synchronise after a
    call, by the span that launched the device event the idle time follows
    (``span | kernel``): ``[ms a call, gaps a call]``."""
    launcher = _launcher(profile, SpanIndex(recorded), host_offset_ns)
    ends = sorted((e - trace.offset_ns, name, corr) for name, _, e, corr in profile.device)
    end_times = [e for e, _, _ in ends]
    sync = [(s, e) for s, e, label in tracing.host_segments(trace.calls,
                                                             layer_spans(recorded).items)
            if label == "sync"]
    out: dict[str, list[float]] = {}
    j = 0
    for gs, ge in trace.idle_gaps():  # both lists are sorted and disjoint
        while j < len(sync) and sync[j][1] <= gs:
            j += 1
        ns, k = 0, j
        while k < len(sync) and sync[k][0] < ge:
            ns += tracing.clip(*sync[k], gs, ge)
            k += 1
        if not ns:
            continue
        k = bisect.bisect_right(end_times, gs) - 1
        what = "nothing before"
        if k >= 0:
            _, name, corr = ends[k]
            what = f"{launcher(corr)} | {name[:80]}"
        got = out.setdefault(what, [0.0, 0.0])
        got[0] += ns / len(trace.calls) / 1e6
        got[1] += 1 / len(trace.calls)
    return out
