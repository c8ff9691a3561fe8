"""The port's spans joined to a profile by correlation id
(``attribution.py``), on synthetic events, and the spans-only and profiled
windows with ``spans_probe.py``'s readings on the CPU at tiny sizes."""

from __future__ import annotations

import dataclasses
import time

import pytest
import torch

from pimbench import attribution, harness, spans_probe, spec, tracing
from pimbench.attribution import UNATTRIBUTED, Profile, SpanIndex
from pimbench.tracing import CallSpan, Trace
from repro_torch.core.spans import Span

SEED = 2**31 + 17


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


def _case(clock_ns: int = 0):
    """The events as a profiler whose clock reads ``clock_ns`` ahead of the
    spans' would record them, and the trace ``read_profile`` would make."""
    profile = Profile(device=[(n, s + clock_ns, e + clock_ns, c) for n, s, e, c in DEVICE],
                      host=[(n, s + clock_ns, e + clock_ns, c) for n, s, e, c in HOST])
    trace = Trace(calls=[CallSpan(64, 0, 100, 200)], device=[(n, s, e) for n, s, e, _ in DEVICE],
                  launches=6, spans=attribution.layer_spans(SPANS).items, offset_ns=clock_ns)
    return profile, trace


def test_the_innermost_span_holding_an_interval():
    index = SpanIndex(SPANS + [_span("open", 150, None, call_id=1)])
    assert index.name(46, 48) == "exec.launch"
    assert index.name(41, 42) == "exec.run_schedule"
    assert index.name(52, 53) == "exec.run_schedule"  # after exec.launch closed
    assert index.name(48, 52) == "exec.run_schedule"  # runs past exec.launch
    assert index.name(95, 96) == "pim.call" and index.name(0, 3) == UNATTRIBUTED
    assert index.name(98, 100) == UNATTRIBUTED and index.name(151, 152) == UNATTRIBUTED


def test_each_kernel_goes_to_the_span_that_launched_it():
    profile, trace = _case()
    attr = attribution.attribute(profile, SPANS, trace)
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
    profile, trace = _case()
    got = attribution.checks(attribution.attribute(profile, SPANS, trace), trace)
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
    profile, trace = _case(clock_ns=1000)
    matched = attribution.attribute(profile, SPANS, trace, host_offset_ns=1000)
    assert matched.device_ns == attribution.attribute(*_case()[:1], SPANS, _case()[1]).device_ns
    missed = attribution.attribute(profile, SPANS, trace)
    assert missed.device_ns == {UNATTRIBUTED: 170}  # every event, clipped to the window
    assert (missed.executor_in_launch, missed.executor_kernels) == (0, 1)
    assert missed.launches == {UNATTRIBUTED: 6}


def test_idle_time_in_the_synchronise_is_named_by_what_it_follows():
    profile, trace = _case()
    # Idle [190, 200) lies in the synchronise [100, 200) and follows the orphan.
    assert attribution.sync_idle(profile, SPANS, trace) == {
        f"{UNATTRIBUTED} | orphan": [pytest.approx(10e-6), 1]}
    moved = attribution.at_offset(trace, 5)
    assert moved.offset_ns == 5 and moved.device[0] == ("pack_kernel", 15, 55)


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
    _, trace = _case()
    idle = tracing.idle_by_host(trace)
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


def test_the_probe_reads_every_window_on_the_cpu(tiny_session):
    untraced = spans_probe.call_stats(tiny_session.drive(0, 60, time.time_ns,
                                                         max_calls=3)[0])
    out = spans_probe.traced(tiny_session, 3, untraced)
    assert out["spans_only"]["calls"] == out["profiled"]["calls"] == 3
    readings = out["raw"]["readings"]
    assert readings["frontend.cache_hit_share"] == 100.0
    assert readings["host.pack_ms"] > 0 and readings["host.unpack_ms"] > 0
    assert readings["pack.in.device_ms"] == 0  # no device on the CPU
    costs = spans_probe.site_costs(tiny_session)
    # pim.call, 3 casts, 3 packings, the stack, the cache, the executor, 1 unpacking;
    # the compile cache's hit (a card run adds the executor's launch count).
    assert costs["sites_a_call"] == {"span": 11, "count": 1}
    assert 0 < costs["span_site_ns"] < costs["span_site_on_ns"]
    assert 0 < costs["off_ns_a_call"] < costs["on_ns_a_call"]
    timed = spans_probe.loop(tiny_session, 4, blocks=2)
    assert timed["rows"] == 40 and len(timed["off_ns"]) == len(timed["on_ns"]) == 1
