"""The traced window's arithmetic: unions, idle gaps named by the host's
work, and reading a profiler's events."""

from __future__ import annotations

import types

import pytest
import torch
from torch.autograd import DeviceType

from pimbench import harness, tracing
from pimbench.tracing import CallSpan, Trace


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
    device = [("pack_kernel", 5, 20), ("bitserial_loop_kernel", 55, 95)]
    return Trace(calls=calls, device=device, launches=6, spans=spans)


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


def test_layer_spans_wrap_and_restore():
    from repro_torch.core.bitplanes import F32, PimType

    original = PimType.__dict__["to_planes"]
    spans = tracing.Spans()
    with tracing.layer_spans(spans):
        assert PimType.__dict__["to_planes"] is not original
        F32.to_planes(torch.zeros(64))
    assert PimType.__dict__["to_planes"] is original
    assert [s[0] for s in spans.items] == ["pack.to_planes"]
    assert spans.items[0][1] <= spans.items[0][2]


class _Event:
    def __init__(self, name, device, start, duration):
        self._v = (name, device, start, duration)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]


def test_read_profile_keeps_device_work_and_counts_launches():
    events = [_Event("bitserial_loop_kernel", DeviceType.CUDA, 10, 5),
              _Event("Memcpy DtoD", DeviceType.CUDA, 20, 2),
              _Event("cudaLaunchKernel", DeviceType.CPU, 9, 1),
              _Event("cuLaunchKernel", DeviceType.CPU, 12, 1),
              _Event("cudaMemcpyAsync", DeviceType.CPU, 19, 1),
              _Event("cudaLaunchKernel", DeviceType.CPU, 500, 1),  # after the window
              _Event("cudaStreamSynchronize", DeviceType.CPU, 25, 1)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    spans = tracing.Spans()
    t = tracing.read_profile(prof, [CallSpan(64, 5, 15, 30)], spans)
    assert t.device == [("bitserial_loop_kernel", 10, 15), ("Memcpy DtoD", 20, 22)]
    assert t.launches == 3


def test_clock_offset_matches_each_call_to_its_synchronise():
    ends = [100, 200, 300]
    assert tracing.clock_offset(ends, [1105, 1207, 1302]) == 1005
    assert tracing.clock_offset(ends, [1105, 1207]) == tracing.clock_offset(ends, [1207, 1105])
    assert tracing.clock_offset(ends, []) == 0


def test_read_profile_moves_device_work_onto_the_harness_clock():
    events = [_Event("bitserial_loop_kernel", DeviceType.CUDA, 1010, 5),
              _Event("cudaLaunchKernel", DeviceType.CPU, 1009, 1),
              _Event("cudaDeviceSynchronize", DeviceType.CPU, 1016, 14)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    t = tracing.read_profile(prof, [CallSpan(64, 5, 15, 30)], tracing.Spans())
    assert t.offset_ns == 1000 and t.device == [("bitserial_loop_kernel", 10, 15)]
    assert t.launches == 1
