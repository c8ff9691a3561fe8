"""The traced window's arithmetic: unions, idle gaps named by the host's
work, reading a profiler's events, and the two traced windows on the CPU."""

from __future__ import annotations

import dataclasses
import gc
import types

import pytest
import torch
from torch.autograd import DeviceType

from pimbench import harness, spec, tracing
from pimbench.tracing import CallSpan, Trace
from repro_torch.core.spans import Span

SEED = 2**31 + 17


def test_union_and_gaps():
    merged = tracing.merge([(5, 8), (0, 2), (1, 3), (7, 10), (12, 13)])
    assert merged == [(0, 3), (5, 10), (12, 13)]
    assert tracing.gaps(merged, 0, 20) == [(3, 5), (10, 12), (13, 20)]
    assert tracing.gaps(merged, 6, 12) == [(10, 12)]
    assert tracing.gaps([], 4, 9) == [(4, 9)]
    assert tracing.clip(0, 10, 5, 7) == 2 and tracing.clip(0, 3, 5, 7) == 0


def _trace() -> Trace:
    """Two calls: [0, 40) returns at 30, [50, 100) returns at 60; packing
    spans inside the first call; the device busy at [5, 20) and [55, 95)."""
    calls = [CallSpan(64, 0, 30, 40), CallSpan(64, 50, 60, 100)]
    spans = [("pack.to_planes", 2, 12), ("exec.run_schedule", 20, 28),
             ("pack.to_planes", 51, 58)]
    device = [("pack_kernel", 5, 20, 1), ("bitserial_loop_kernel", 55, 95, 2)]
    return Trace(calls=calls, device=device, host=[], launches=6, spans=spans)


def test_host_segments_take_the_innermost_span():
    segments = tracing.host_segments(_trace().calls, _trace().spans)
    assert segments[:6] == [(0, 2, "frontend"), (2, 12, "pack.to_planes"),
                            (12, 20, "frontend"), (20, 28, "exec.run_schedule"),
                            (28, 30, "frontend"), (30, 40, "sync")]
    assert (40, 50, "harness") in segments and segments[-1] == (60, 100, "sync")


def test_idle_time_is_named_by_what_the_host_did():
    t = _trace()
    assert t.busy_s() == pytest.approx(55e-9) and t.window_s == pytest.approx(100e-9)
    idle = tracing.idle_by_host(t)
    # Idle: [0, 5) frontend 2 + to_planes 3, [20, 55): exec 8, frontend 2,
    # sync 10, harness 10, to_planes 4 (51 - 55) and frontend 1; [95, 100) sync.
    assert idle == pytest.approx({"frontend": 5e-9, "pack.to_planes": 7e-9,
                                  "exec.run_schedule": 8e-9, "sync": 15e-9,
                                  "harness": 10e-9})
    assert sum(idle.values()) == pytest.approx(t.window_s - t.busy_s())
    out = harness.breakdown(t)
    assert out["device_ops"][0] == ["bitserial_loop_kernel", pytest.approx(40e-9)]
    assert out["idle_gaps"][0] == ["sync", pytest.approx(15e-9)]


def test_the_traced_windows_record_the_ports_spans_and_counters(monkeypatch):
    """The spans-only and profiled windows each record the port's spans of
    every call, with the garbage collector off, and the run carries the
    port's counters' rise over the spans-only window: on the CPU the
    compile cache's hits, a call each."""
    cell = spec.load_cell("memristive.resnet50_f32")
    cell = dataclasses.replace(cell, traffic={**cell.traffic, "rows": [[40, 2], [100, 1]],
                                              "trace_calls": 3})
    session = harness.Session(cell, SEED, torch.device("cpu"))
    session.warm_up()
    collector = []
    drive = session.drive
    monkeypatch.setattr(session, "drive",
                        lambda *a, **k: collector.append(gc.isenabled()) or drive(*a, **k))
    got = harness.Run(cell=cell, calls=[], window_s=0.0, setup_s=0.0, peak_bytes=None,
                      peak=None)
    assert harness.traced_windows(session, got, 0, 60) == (6, [])
    assert collector == [False, False] and gc.isenabled()
    for recorded in (got.spans_only, got.profiled):
        tops = [s for s in recorded if s.parent is None]
        assert [s.name for s in tops] == ["pim.call"] * 3
        assert {"frontend.cast", "pack.to_planes", "unpack.from_planes"} <= {
            s.name for s in recorded}
    assert got.counters.get("ir.compile.hits") == 3
    assert len(got.trace.calls) == 3 and got.attribution.calls == 3
    # The trace's spans are the profiled window's, but the calls' own.
    assert sorted(got.trace.spans) == sorted(
        (s.name, s.start_ns, s.end_ns) for s in got.profiled if s.name != "pim.call")


class _Event:
    def __init__(self, name, device, start, duration, corr=0):
        self._v = (name, device, start, duration, corr)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]


def _profile(events):
    return types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))


def test_read_profile_keeps_device_work_and_counts_launches():
    events = [_Event("bitserial_loop_kernel", DeviceType.CUDA, 10, 5, 1),
              _Event("Memcpy DtoD", DeviceType.CUDA, 20, 2, 3),
              _Event("cudaLaunchKernel", DeviceType.CPU, 9, 1, 1),
              _Event("cuLaunchKernel", DeviceType.CPU, 12, 1, 2),
              _Event("cudaMemcpyAsync", DeviceType.CPU, 19, 1, 3),
              _Event("cudaLaunchKernel", DeviceType.CPU, 500, 1, 4),  # after the window
              _Event("cudaStreamSynchronize", DeviceType.CPU, 25, 1, 5)]
    t = tracing.read_profile(_profile(events), [CallSpan(64, 5, 15, 30)], [])
    assert t.device == [("bitserial_loop_kernel", 10, 15, 1), ("Memcpy DtoD", 20, 22, 3)]
    assert t.host[0] == ("cudaLaunchKernel", 9, 10, 1) and len(t.host) == 5
    assert t.launches == 3


def test_read_profile_takes_the_profilers_clock_as_the_spans():
    """The profiler stamps host events on the port's span clock, so nothing
    is moved; the call's own span and an open one are left out of the
    spans that name the idle gaps."""
    events = [_Event("bitserial_loop_kernel", DeviceType.CUDA, 1010, 5, 7),
              _Event("cudaLaunchKernel", DeviceType.CPU, 1009, 1, 7),
              _Event("cudaDeviceSynchronize", DeviceType.CPU, 1016, 14, 8)]
    recorded = [Span("pim.call", 1000, 1015, None, 0, {}),
                Span("exec.launch", 1008, 1011, 0, 0, {}),
                Span("exec.build", 1012, None, 0, 0, {})]
    t = tracing.read_profile(_profile(events), [CallSpan(64, 1000, 1015, 1030)], recorded)
    assert t.device == [("bitserial_loop_kernel", 1010, 1015, 7)]
    assert t.spans == [("exec.launch", 1008, 1011)] and t.launches == 1
