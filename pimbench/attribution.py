"""The port's own spans joined to a ``torch.profiler`` trace: which layer of
the port launched each device operation, and each layer's host time.

The port records spans at its layer boundaries (``repro_torch.core.spans``)
on ``time.time_ns()``, the clock on which the profiler stamps host events.
Every device event (kernel, copy, set) carries the correlation id of the
runtime call that launched it.  A device event's time goes to the innermost
port span that holds its launch call; one whose launch call is missing from
the trace or lies in no span is ``unattributed``.

A traced run measures two windows after the untraced one the harness
times: a spans-only window (:func:`spans_window`: spans on, profiler off),
whose host times carry no profiler cost, and the profiled window
(:func:`profiled_window`: both on), whose device time :func:`attribute`
splits by the span that launched it.  A metric's reader takes what it
needs from the run by a span's name (:meth:`Attribution.ms_a_call`,
:func:`host_ms`) or a counter's (``run.counters``).
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
LAUNCH = "exec.launch"


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


def attribute(trace: tracing.Trace, recorded: list[port_spans.Span]) -> Attribution:
    """Split ``trace``'s window by the port's spans ``recorded`` in it.
    Device events are clipped to the window as ``trace`` clips them, so the
    parts sum to the trace's device time."""
    index = SpanIndex(recorded)
    runtime = {c: (s, e) for _, s, e, c in trace.host if c}
    device_ns: dict[str, int] = {}
    executor_ns: dict[str, int] = {}
    inside = total = 0
    for name, s, e, corr in trace.device:
        ns = tracing.clip(s, e, trace.start, trace.end)
        call = runtime.get(corr) if corr else None
        where = UNATTRIBUTED if call is None else index.name(*call)
        device_ns[where] = device_ns.get(where, 0) + ns
        if tracing.EXECUTOR_KERNEL.search(name):
            executor_ns[where] = executor_ns.get(where, 0) + ns
            if ns:
                total += 1
                inside += where == LAUNCH
    launches: dict[str, int] = {}
    for name, s, e, _ in trace.host:
        if tracing.LAUNCH_CALL.match(name) and trace.start <= s <= trace.end:
            where = index.name(s, e)
            launches[where] = launches.get(where, 0) + 1
    return Attribution(device_ns=device_ns, executor_ns=executor_ns, launches=launches,
                       executor_in_launch=inside, executor_kernels=total,
                       calls=len(trace.calls))


def host_ms(recorded: list[port_spans.Span], names) -> float | None:
    """Host ms a call inside the spans ``names`` (which do not nest in one
    another), over the recording's ``pim.call`` spans."""
    calls = sum(1 for s in recorded if s.name == tracing.CALL_SPAN)
    if not calls:
        return None
    return sum(s.end_ns - s.start_ns for s in recorded
               if s.name in names and s.end_ns is not None) / calls / 1e6


def cache_hit_share(*recordings: list[port_spans.Span]) -> float | None:
    """The share of ``pim.call`` spans, in %, whose call made no compile,
    build or table upload (no ``ir.compile`` or ``exec.build`` span)."""
    calls = cold = 0
    for recorded in recordings:
        ids = {s.call_id for s in recorded if s.name == tracing.CALL_SPAN}
        calls += len(ids)
        cold += len({s.call_id for s in recorded if s.name in COLD} & ids)
    return None if not calls else (calls - cold) / calls * 100


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
    """The five readings of the port's spans: device ms a call launched by
    packing's input and output sides (profiled window; None where the trace
    holds no device event, as on the CPU), host ms a call in them
    (spans-only window), and the share of calls that hit every cache."""
    device = bool(attr.device_ns)
    return {
        "pack.in.device_ms": attr.ms_a_call(PACK_IN) if device else None,
        "pack.out.device_ms": attr.ms_a_call(PACK_OUT) if device else None,
        "host.pack_ms": host_ms(spans_only, PACK_IN),
        "host.unpack_ms": host_ms(spans_only, PACK_OUT),
        "frontend.cache_hit_share": cache_hit_share(spans_only, profiled),
    }


def reading(run, name: str) -> float | None:
    """One of :func:`layer_readings` from a run; None without a traced window."""
    if run.attribution is None:
        return None
    return layer_readings(run.attribution, run.spans_only, run.profiled)[name]


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


def checks_hold(got: dict[str, dict]) -> bool:
    """Every one of :func:`checks` within 1 %; the launches inside
    ``exec.launch`` exactly."""
    return all(c["value"] == c["of"] if name == "executor_in_launch"
               else within(c["value"], c["of"]) for name, c in got.items())
