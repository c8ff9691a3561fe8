"""The port's Fig 8 offload analyzer against the JAX reference: given the
TPU v5e's numbers as a ``GPUConfig`` (16-bit peak, HBM bandwidth, link
bandwidth), every field of the port's verdict equals the reference's
``analyze`` under ``TPU_V5E`` — ``gpu_time_s`` in place of ``tpu_time_s`` —
on a grid of workloads, chip counts, both bases and three gate-count
sources; ``pim_time`` is equal exactly."""

import dataclasses
import itertools

import pytest

from repro.core import analyzer as ref_analyzer
from repro.core import costmodel as ref_cm
from repro_torch.core import analyzer, costmodel

V5E = costmodel.GPUConfig(
    name="tpu_v5e", mem_bw=ref_cm.TPU_V5E.hbm_bw, peak_fp32=ref_cm.TPU_V5E.peak_bf16,
    peak_fp16=ref_cm.TPU_V5E.peak_bf16, mem_bytes=ref_cm.TPU_V5E.hbm_bytes,
    max_power_w=ref_cm.TPU_V5E.max_power_w, link_bw=ref_cm.TPU_V5E.ici_bw)

WORKLOADS = [
    dict(name=f"w{i}", flops=flops, hbm_bytes=bytes_, collective_wire_bytes=coll,
         dtype_bits=bits)
    for i, (flops, bytes_, coll, bits) in enumerate(itertools.product(
        (6e9, 1.8e16, 5.3e10), (6e9, 60e9, 0.0), (0.0, 4e9), (32, 16)))
]


def _gate_counts(source):
    if source == "netlists":
        return analyzer.netlist_gate_counts(), ref_analyzer.netlist_gate_counts()
    if source == "paper":
        return dict(costmodel.PAPER_GATE_COUNTS), dict(ref_cm.PAPER_GATE_COUNTS)
    return None, None


def test_v5e_as_gpu_config_carries_the_reference_numbers():
    assert (V5E.peak_fp16, V5E.mem_bw, V5E.link_bw) == (197e12, 819e9, 50e9)


@pytest.mark.parametrize("basis", ["memristive", "dram"])
@pytest.mark.parametrize("source", [None, "paper", "netlists"])
def test_verdicts_equal_reference_field_for_field(basis, source):
    pim, ref_pim = ((costmodel.MEMRISTIVE_PIM, ref_cm.MEMRISTIVE_PIM) if basis == "memristive"
                    else (costmodel.DRAM_PIM, ref_cm.DRAM_PIM))
    counts, ref_counts = _gate_counts(source)
    assert counts == ref_counts
    for spec, chips in itertools.product(WORKLOADS, (1, 4)):
        w, ref_w = analyzer.Workload(**spec), ref_analyzer.Workload(**spec)
        assert w.reuse == ref_w.reuse
        assert analyzer.pim_time(w, pim, counts) == ref_analyzer.pim_time(ref_w, ref_pim,
                                                                          ref_counts)
        got = dataclasses.asdict(analyzer.analyze(w, chips, pim, V5E, counts))
        want = dataclasses.asdict(ref_analyzer.analyze(ref_w, chips, ref_pim, ref_cm.TPU_V5E,
                                                       ref_counts))
        want["gpu_time_s"] = want.pop("tpu_time_s")
        assert got == want, (spec, chips)
        assert got["gpu_time_s"] == analyzer.gpu_time(w, chips, V5E)


def test_gpu_time_is_the_three_term_roofline_on_the_h100():
    h = costmodel.H100
    w = analyzer.Workload("x", flops=1e15, hbm_bytes=1e12, collective_wire_bytes=1e12)
    assert analyzer.gpu_time(w) == max(1e15 / h.peak_fp16, 1e12 / h.mem_bw,
                                       1e12 / h.link_bw)
    assert analyzer.gpu_time(w, chips=4) == max(1e15 / (4 * h.peak_fp16),
                                                1e12 / (4 * h.mem_bw), 1e12 / h.link_bw)
    assert analyzer.analyze(w).gpu_time_s == analyzer.gpu_time(w)


def test_quickstart_verdicts_against_the_h100():
    """Decode (reuse 1) is PIM's quadrant; training at high reuse is not."""
    decode = analyzer.analyze(analyzer.Workload("decode", flops=6e9, hbm_bytes=6e9))
    train = analyzer.analyze(analyzer.Workload("train", flops=1.8e16, hbm_bytes=60e9))
    assert decode.reuse_is_low and decode.pim_wins and decode.speedup > 1
    assert not train.reuse_is_low and not train.pim_wins
    assert decode.quadrant == "high-CC/low-reuse" and train.quadrant == "high-CC/high-reuse"
