"""The frozen bounds and the shares read from them, on fixed inputs."""

from __future__ import annotations

import pytest

from pimbench import roofline, spec
from pimbench.harness import CallRecord, Run
from pimbench.tracing import CallSpan, Trace

H100 = roofline.peak_for("NVIDIA H100 80GB HBM3")
N = 1 << 24


def _work(program: str, basis: str) -> dict:
    return spec.load_json(spec.PKG / "programs" / f"{program}.json")["work"][basis]


def test_h100_int32_peak():
    assert roofline.int32_ops_per_s(H100) == pytest.approx(16.727e12, rel=1e-4)
    assert roofline.peak_for("a card the table lacks") is None


@pytest.mark.parametrize("program, basis, ms, term", [
    ("f32_mac", "memristive", 0.4065, "operations"),
    ("f32_mac", "dram", 0.2726, "operations"),
    ("int8_mac", "memristive", 0.0200, "bytes"),
])
def test_kernel_bounds_at_2_24_rows(program, basis, ms, term):
    seconds, which = roofline.kernel_bound_s(_work(program, basis), N, H100)
    assert seconds * 1e3 == pytest.approx(ms, abs=1e-4) and which == term


def test_call_bound_counts_element_bytes():
    f32 = spec.load_json(spec.PKG / "programs" / "f32_mac.json")
    seconds, which = roofline.call_bound_s(f32["work"]["memristive"], f32["row_bytes"], N, H100)
    assert which == "operations" and seconds * 1e3 == pytest.approx(0.4065, abs=1e-4)
    int8 = spec.load_json(spec.PKG / "programs" / "int8_mac.json")
    seconds, which = roofline.call_bound_s(int8["work"]["memristive"], int8["row_bytes"], N, H100)
    assert which == "bytes" and seconds == pytest.approx(4 * N / 3.35e12)


def test_words_need_no_padding():
    assert [roofline.words(r) for r in (1, 32, 33, 8000)] == [1, 1, 2, 250]


def _run(cell: str, device, calls) -> Run:
    """A run whose measured window repeats the traced calls' rows over the
    traced window's length."""
    trace = Trace(calls=calls, device=[(*d, 0) for d in device], host=[],
                  launches=10 * len(calls), spans=[])
    return Run(cell=spec.load_cell(cell), calls=[CallRecord(c.rows, 0.05, 0.001) for c in calls],
               window_s=trace.window_s, setup_s=1.0, peak_bytes=None, peak=H100, trace=trace)


def test_shares_from_a_made_up_trace():
    """Two calls of 2^24 rows in a 100 ms window, each with 8.13 ms of loop
    kernel: the loop kernel at 0.4065 / 8.13 = 5 %, the call at 2 x 0.4065 /
    100 ms."""
    ms = 1_000_000
    calls = [CallSpan(N, 0, 1 * ms, 50 * ms), CallSpan(N, 50 * ms, 51 * ms, 100 * ms)]
    device = [("bitserial_loop_kernel(unsigned const*)", 10 * ms, 10 * ms + 8_130_000),
              ("bitserial_loop_kernel(unsigned const*)", 60 * ms, 60 * ms + 8_130_000),
              ("vectorized_elementwise_kernel", 2 * ms, 9 * ms)]
    run = _run("memristive.f32_bulk", device, calls)
    loop = spec.reader("bitserial_loop_roofline").read(run)
    assert loop == pytest.approx(0.40646 / 8.13 * 100, rel=1e-3)
    assert spec.reader("bitserial_unrolled_roofline").read(run) is None
    assert spec.reader("sim_mfu").read(run) == pytest.approx(2 * 0.40646 / 100 * 100, rel=1e-3)
    assert spec.reader("exec.device_ms").read(run) == pytest.approx(8.13)
    assert spec.reader("pack.device_ms").read(run) == pytest.approx(3.5)
    assert spec.reader("host.launches_per_call").read(run) == 10
    busy = (8.13 * 2 + 7) / 100
    assert spec.reader("device.idle_share").read(run) == pytest.approx((1 - busy) * 100)


def test_no_share_without_a_peak_or_a_kernel():
    calls = [CallSpan(N, 0, 1, 10)]
    run = _run("memristive.int8_bulk", [("elementwise", 0, 5)], calls)
    assert spec.reader("bitserial_unrolled_roofline").read(run) is None
    assert spec.reader("exec.device_ms").read(run) is None
    run.peak = None
    assert spec.reader("sim_mfu").read(run) is None
