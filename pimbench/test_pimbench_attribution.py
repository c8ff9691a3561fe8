"""The port's spans joined to a profile by correlation id
(``attribution.py``), on synthetic events, and a traced run's readings of
the port's spans on the CPU at tiny sizes."""

from __future__ import annotations

import dataclasses
import re
import time

import pytest
import torch

from pimbench import attribution, harness, spec, tracing
from pimbench.attribution import UNATTRIBUTED, SpanIndex
from pimbench.harness import CallRecord, Run
from pimbench.tracing import CallSpan, Trace
from repro_torch.core import spans as port_spans
from repro_torch.core.spans import Span

SEED = 2**31 + 17
READINGS = ("pack.in.device_ms", "pack.out.device_ms", "host.pack_ms", "host.unpack_ms",
            "frontend.cache_hit_share")


def _span(name, start, end, parent=None, call_id=0, **attrs):
    return Span(name, start, end, parent, call_id, attrs)


# One call [0, 200), returning at 100: the port's spans, the host's runtime
# calls and the device's events, each launch inside one span.
SPANS = [_span("pim.call", 1, 99), _span("frontend.cast", 2, 5, 0),
         _span("pack.to_planes", 6, 30, 0), _span("pack.stack", 31, 35, 0),
         _span("frontend.compile_cache", 36, 38, 0), _span("exec.run_schedule", 40, 60, 0),
         _span("exec.launch", 45, 50, 5), _span("unpack.from_planes", 61, 90, 0)]
HOST = [("cudaLaunchKernel", 10, 12, 1), ("cudaLaunchKernel", 32, 33, 2),
        ("cudaLaunchKernel", 41, 42, 3), ("cuLaunchKernel", 46, 48, 4),
        ("cudaLaunchKernel", 62, 64, 5), ("cudaLaunchKernel", 95, 96, 6),
        ("cudaDeviceSynchronize", 100, 199, 7)]
DEVICE = [("pack_kernel", 20, 60, 1), ("stack_copy", 60, 70, 2), ("pad_kernel", 70, 75, 3),
          ("bitserial_loop_kernel", 75, 150, 4), ("unpack_kernel", 150, 180, 5),
          ("tail_kernel", 180, 185, 6), ("orphan", 185, 190, 99)]


def _case(clock_ns: int = 0) -> Trace:
    """The events as a profiler whose clock reads ``clock_ns`` ahead of the
    spans' would record them, as ``read_profile`` keeps them."""
    return Trace(calls=[CallSpan(64, 0, 100, 200)],
                 device=[(n, s + clock_ns, e + clock_ns, c) for n, s, e, c in DEVICE],
                 host=[(n, s + clock_ns, e + clock_ns, c) for n, s, e, c in HOST],
                 launches=6, spans=[(s.name, s.start_ns, s.end_ns) for s in SPANS
                                    if s.name != "pim.call"])


def test_the_innermost_span_holding_an_interval():
    index = SpanIndex(SPANS + [_span("open", 150, None, call_id=1)])
    assert index.name(46, 48) == "exec.launch"
    assert index.name(41, 42) == "exec.run_schedule"
    assert index.name(52, 53) == "exec.run_schedule"  # after exec.launch closed
    assert index.name(48, 52) == "exec.run_schedule"  # runs past exec.launch
    assert index.name(95, 96) == "pim.call" and index.name(0, 3) == UNATTRIBUTED
    assert index.name(98, 100) == UNATTRIBUTED and index.name(151, 152) == UNATTRIBUTED


def test_each_kernel_goes_to_the_span_that_launched_it():
    attr = attribution.attribute(_case(), SPANS)
    assert attr.device_ns == {"pack.to_planes": 40, "pack.stack": 10, "exec.run_schedule": 5,
                              "exec.launch": 75, "unpack.from_planes": 30, "pim.call": 5,
                              UNATTRIBUTED: 5}
    assert attr.executor_ns == {"exec.launch": 75}
    assert (attr.executor_in_launch, attr.executor_kernels) == (1, 1)
    assert attr.launches == {"pack.to_planes": 1, "pack.stack": 1, "exec.run_schedule": 1,
                             "exec.launch": 1, "unpack.from_planes": 1, "pim.call": 1}
    assert attr.ms_a_call(attribution.PACK_IN) == pytest.approx(50e-6)
    assert attr.ms_a_call(attribution.PACK_OUT) == pytest.approx(30e-6)


def test_the_checks_hold_and_the_unattributed_rest_is_counted():
    trace = _case()
    got = attribution.checks(attribution.attribute(trace, SPANS), trace)
    # The rest: the executor's padding, the call's own launch and the orphan.
    assert got["pack_parts_ms"]["rest"] == pytest.approx(15e-6)
    assert got["pack_parts_ms"]["value"] == pytest.approx(got["pack_parts_ms"]["of"])
    assert got["pack_parts_ms"]["of"] == pytest.approx(95e-6)
    assert got["exec_launch_ms"] == {"value": pytest.approx(75e-6), "of": pytest.approx(75e-6)}
    assert got["executor_in_launch"] == {"value": 1, "of": 1}
    assert got["launches_by_span"]["value"] == got["launches_by_span"]["of"] == 6
    for check in ("pack_parts_ms", "exec_launch_ms"):
        assert attribution.within(got[check]["value"], got[check]["of"])


def test_a_clock_that_differs_leaves_the_launches_outside_their_spans():
    """Why no offset is applied: the spans and the profiler's host events
    share a clock, and one that read otherwise would leave every launch
    outside the span that made it."""
    missed = attribution.attribute(_case(clock_ns=1000), SPANS)
    assert missed.device_ns == {UNATTRIBUTED: 0}  # every event, and none in the window
    assert (missed.executor_in_launch, missed.executor_kernels) == (0, 0)
    assert missed.launches == {}
    ahead = attribution.attribute(_case(clock_ns=30), SPANS)
    assert ahead.executor_ns == {"unpack.from_planes": 75}
    assert (ahead.executor_in_launch, ahead.executor_kernels) == (0, 1)


def test_host_times_and_the_cache_hit_share():
    cold = [_span("pim.call", 0, 100), _span("frontend.compile_cache", 10, 60, 0),
            _span("ir.compile", 11, 59, 1), _span("pack.to_planes", 60, 70, 0)]
    warm = [_span("pim.call", 200, 300, call_id=c) for c in (1, 2, 3)]
    assert attribution.cache_hit_share(cold, warm) == pytest.approx(75.0)
    assert attribution.cache_hit_share(warm) == 100.0
    assert attribution.cache_hit_share([]) is None
    assert attribution.host_ms(SPANS, attribution.PACK_IN) == pytest.approx(31e-6)
    assert attribution.host_ms(SPANS, attribution.PACK_OUT) == pytest.approx(29e-6)
    assert attribution.host_ms([], attribution.PACK_IN) is None


def test_the_idle_gaps_keep_their_labels_from_the_ports_spans():
    idle = tracing.idle_by_host(_case())
    assert "pim.call" not in idle
    # Idle [0, 20): frontend [0, 2) and [5, 6), the cast [2, 5), packing [6, 20);
    # [190, 200): the synchronise.
    assert idle == pytest.approx({"frontend": 3e-9, "frontend.cast": 3e-9,
                                  "pack.to_planes": 14e-9, "sync": 10e-9})


@pytest.fixture
def tiny_session():
    cell = spec.load_cell("memristive.resnet50_f32")
    cell = dataclasses.replace(cell, traffic={**cell.traffic, "rows": [[40, 2], [100, 1]],
                                              "trace_calls": 3})
    session = harness.Session(cell, SEED, torch.device("cpu"))
    session.warm_up()
    return session


def test_the_spans_only_window_on_the_cpu(tiny_session):
    calls, failures, recorded = attribution.spans_window(tiny_session, 0, 4, 60)
    assert len(calls) == 4 and not failures
    tops = [s for s in recorded if s.parent is None]
    assert [s.name for s in tops] == ["pim.call"] * 4
    assert [s.call_id for s in tops] == [0, 1, 2, 3]
    assert [s.attrs["rows"] for s in tops] == [tiny_session.calls.rows(i) for i in range(4)]
    for (_, start, returned, _), top in zip(calls, tops):
        assert start <= top.start_ns <= top.end_ns <= returned
    assert attribution.host_ms(recorded, attribution.PACK_IN) > 0
    assert attribution.cache_hit_share(recorded) == 100.0


def _table_spans() -> set[str]:
    """The span names in the table of ``repro_torch.core.spans``'s docstring."""
    return set(re.findall(r"^``([a-z_.]+)``  ", port_spans.__doc__, flags=re.M))


# Spans of the table that a warm call on the CPU does not pass: a compile or
# a build on a miss, and the card's kernel launches.
NOT_ON_A_WARM_CPU_CALL = {"ir.compile", "exec.build", "exec.launch"}


@pytest.mark.parametrize("cell", ["memristive.resnet50_f32", "memristive.int8_bulk"])
def test_a_traced_run_reads_the_ports_spans_on_the_cpu(monkeypatch, cell):
    """A traced run at the cell's CPU sizes reads the five span readings
    (on the CPU the device readings find no device and read nothing), the
    attribution's checks hold, the run carries the port's counters, and
    the spans recorded are the sites the port's table names."""
    runs = []
    read_metrics = harness.read_metrics
    monkeypatch.setattr(harness, "read_metrics",
                        lambda entries, run: runs.append(run) or read_metrics(entries, run))
    traffic = {"rows": spec.load_cell(cell).traffic["cpu_rows"], "trace_calls": 4}
    result, _ = harness.run_cell(cell, SEED, 0.4, True, t_start=time.perf_counter(),
                                 device="cpu", traffic=traffic)
    assert result["correct"] and list(result)[-1] == "checks"
    twin = "waves." if "resnet50" in cell else ""
    metrics = result["metrics"]
    assert metrics[f"{twin}frontend.cache_hit_share"]["value"] == 100.0
    assert metrics[f"{twin}host.pack_ms"]["value"] > 0
    assert metrics[f"{twin}host.unpack_ms"]["value"] > 0
    assert f"{twin}pack.in.device_ms" not in metrics
    assert f"{twin}pack.out.device_ms" not in metrics
    assert result["attribution"]["holds"]
    (run,) = runs
    calls = sum(s.name == "pim.call" for s in run.spans_only)
    assert calls >= 1 and run.counters["ir.compile.hits"] == calls
    table = _table_spans()
    assert {"pim.call", "pack.to_planes", "unpack.from_planes"} <= table
    for recorded in (run.spans_only, run.profiled):
        assert {s.name for s in recorded} == table - NOT_ON_A_WARM_CPU_CALL


def test_the_readers_over_a_made_up_run():
    """The ten readers over the synthetic call: packing's sides by the span
    that launched them, host times over the spans-only window, and the
    cache-hit share over both windows."""
    trace = _case()
    run = Run(cell=spec.load_cell("memristive.f32_bulk"), calls=[CallRecord(64, 2e-7, 1e-7)],
              window_s=2e-7, setup_s=1.0, peak_bytes=None, peak=None, trace=trace,
              attribution=attribution.attribute(trace, SPANS), spans_only=SPANS,
              profiled=SPANS, counters={})
    want = {"pack.in.device_ms": 50e-6, "pack.out.device_ms": 30e-6, "host.pack_ms": 31e-6,
            "host.unpack_ms": 29e-6, "frontend.cache_hit_share": 100.0}
    for name in READINGS:
        assert spec.reader(name).read(run) == pytest.approx(want[name])
        assert spec.reader(f"waves.{name}").read(run) == pytest.approx(want[name])
    run.attribution = None
    assert all(spec.reader(name).read(run) is None for name in READINGS)
