"""The port's cost model and metrics against the JAX reference: every field
of every shared configuration and paper table, the derived throughputs and
power, and the Fig 4 points are equal; the port's GPU configurations add
only ``link_bw`` (NVLink, from each data sheet); the H100 configuration
carries the data sheet's numbers."""

import dataclasses

import pytest

from repro.core import costmodel as ref_cm
from repro.core import ir as ref_ir
from repro.core import metrics as ref_metrics
from repro_torch.core import costmodel, ir, metrics

SHARED = ("MEMRISTIVE_PIM", "DRAM_PIM", "A6000", "A100")
TABLES = ("PAPER_GPU_MEASURED", "PAPER_GATE_COUNTS", "PAPER_PIM_THROUGHPUT")
LINK_BW = {"A6000": 112.5e9, "A100": 600e9, "H100": 900e9}  # NVLink, data sheets


@pytest.mark.parametrize("name", SHARED + TABLES + ("GIB",))
def test_shared_configs_and_tables_equal_reference(name):
    port, ref = getattr(costmodel, name), getattr(ref_cm, name)
    if dataclasses.is_dataclass(port):
        fields = dataclasses.asdict(port)
        if isinstance(port, costmodel.GPUConfig):
            assert fields.pop("link_bw") == LINK_BW[name]
        assert fields == dataclasses.asdict(ref)
        assert type(port).__name__ == type(ref).__name__
    else:
        assert port == ref


@pytest.mark.parametrize("name", ("MEMRISTIVE_PIM", "DRAM_PIM"))
def test_pim_derived_numbers_equal_reference(name):
    port, ref = getattr(costmodel, name), getattr(ref_cm, name)
    for prop in ("num_crossbars", "total_rows", "bitwise_throughput", "max_power_w"):
        assert getattr(port, prop) == getattr(ref, prop), prop
    for gates in (1, 288, 1995, 5779, 9059, 12968):
        assert port.op_latency_cycles(gates) == ref.op_latency_cycles(gates)
        assert port.op_throughput(gates) == ref.op_throughput(gates)
        assert port.op_throughput_cycles(gates) == ref.op_throughput_cycles(gates)
        assert port.op_throughput_per_watt(gates) == ref.op_throughput_per_watt(gates)
        for n_ops, rows in ((1e6, None), (1e12, None), (5e9, 1 << 20)):
            assert port.time_for_ops(n_ops, gates, rows) == ref.time_for_ops(n_ops, gates, rows)
    basis = port.basis
    for op, nbits in (("fixed_add", 32), ("float_mul", 32), ("bf16_add", 16)):
        rp = ir.op_cost(op, nbits, basis=basis)
        rr = ref_ir.op_cost(op, nbits, basis=basis)
        assert port.report_throughput(rp) == ref.report_throughput(rr)
        assert port.report_parallel_throughput(rp) == ref.report_parallel_throughput(rr)
        assert port.report_hbm_bytes(rp, 4096) == ref.report_hbm_bytes(rr, 4096)


@pytest.mark.parametrize("name", ("A6000", "A100", "H100"))
def test_gpu_derived_numbers(name):
    gpu = getattr(costmodel, name)
    for bytes_per_op in (2, 6, 12):
        assert gpu.membound_throughput(bytes_per_op) == gpu.mem_bw / bytes_per_op
        assert metrics.accelerator_membound(gpu, bytes_per_op) == gpu.mem_bw / bytes_per_op
    assert gpu.compute_throughput(2.0) == gpu.peak_fp32 / 2.0
    assert gpu.compute_throughput(2.0, fp16=True) == gpu.peak_fp16 / 2.0
    if name != "H100":
        ref = getattr(ref_cm, name)
        assert gpu.membound_throughput(12) == ref.membound_throughput(12)
        assert gpu.compute_throughput(3.0, fp16=True) == ref.compute_throughput(3.0, fp16=True)


def test_h100_data_sheet_and_machine_balance():
    h = costmodel.H100
    assert (h.mem_bw, h.peak_fp32, h.peak_fp16, h.mem_bytes, h.max_power_w, h.link_bw) == (
        3.35e12, 67e12, 989e12, 80 * costmodel.GIB, 700.0, LINK_BW["H100"])
    assert 250 < metrics.machine_balance(h) < 320
    assert not hasattr(costmodel, "TPU_V5E") and not hasattr(costmodel, "TPUConfig")


@pytest.mark.parametrize("io_bits", [None, {"float32_add": 96, "fixed32_mul": 128}])
def test_fig4_points_equal_reference(io_bits):
    port = metrics.fig4_points(costmodel.MEMRISTIVE_PIM, costmodel.A6000,
                               costmodel.PAPER_GATE_COUNTS, io_bits)
    ref = ref_metrics.fig4_points(ref_cm.MEMRISTIVE_PIM, ref_cm.A6000,
                                  ref_cm.PAPER_GATE_COUNTS, io_bits)
    assert [dataclasses.asdict(p) for p in port] == [dataclasses.asdict(p) for p in ref]
    assert [p.improvement for p in port] == [p.improvement for p in ref]


def test_reuse_and_complexity_metrics_equal_reference():
    for n in (16, 128, 512):
        assert metrics.data_reuse_matmul(n) == ref_metrics.data_reuse_matmul(n)
    for k in (1, 3, 7):
        assert metrics.data_reuse_conv(k) == ref_metrics.data_reuse_conv(k)
    assert metrics.compute_complexity(1995, 96) == ref_metrics.compute_complexity(1995, 96)
