"""Analytical cost model for PIM and accelerator configurations (paper §2, Table 1).

Calibration notes (verified against the paper's own Fig 3 numbers):

* memristive rows = 48 GiB · 8 / 1024 cols = 402,653,184; with the 9N-gate
  ripple adder and 2 cycles/gate (MAGIC init+exec) a 32-bit fixed add takes
  576 cycles → 402.65e6 · 333 MHz / 576 = **232.8 TOPS** (paper: 233 TOPS ✓).
* DRAM PIM in the paper uses the same schedules at 0.5 MHz → 0.349 TOPS
  (paper: 0.35 ✓) — that clock-scaled parity is retained only for the
  paper-facing columns.  Our own DRAM numbers come from the ``dram``
  ``LogicBasis``: genuine MAJ3/NOT schedules (``ir.compile_op(...,
  basis="dram")``) costed in AAP/TRA row commands, e.g. the 32-bit fixed add
  lowers to 96 MAJ + 32 NOT = 546 row cycles → 0.369 TOPS — independently
  derived, within 6% of the paper's convention.
* max power = rows · f · E_gate: memristive 402.65e6·333e6·6.4 fJ = **858 W**
  (paper: 860 W ✓); DRAM 402.65e6·0.5e6·391 fJ = **78.7 W** (paper: 80 W ✓).
* paper-calibrated gate counts back-solved from Fig 3 throughputs are kept in
  ``PAPER_GATE_COUNTS`` next to our own netlist counts (``aritpim.gate_counts``),
  so benchmarks can report both columns.
* accelerators: the paper's A6000 and A100, and the H100 this package runs
  on, all as ``GPUConfig`` — the GPU side of every PIM-vs-GPU comparison.
"""

from __future__ import annotations

import dataclasses

GIB = 1024**3


@dataclasses.dataclass(frozen=True)
class PIMConfig:
    name: str
    crossbar_rows: int
    crossbar_cols: int
    mem_bytes: int
    gate_energy_j: float
    clock_hz: float
    cycles_per_gate: int = 2  # MAGIC init + execute (calibrates to Fig 3)
    basis: str = "memristive"  # LogicBasis used for native compilation

    @property
    def num_crossbars(self) -> int:
        bits = self.mem_bytes * 8
        return bits // (self.crossbar_rows * self.crossbar_cols)

    @property
    def total_rows(self) -> int:
        return self.num_crossbars * self.crossbar_rows

    @property
    def bitwise_throughput(self) -> float:
        """Column gates per second across the whole memory (paper §2.2)."""
        return self.total_rows * self.clock_hz

    @property
    def max_power_w(self) -> float:
        return self.total_rows * self.clock_hz * self.gate_energy_j

    # ---- per-op analytics -------------------------------------------------
    def op_latency_cycles(self, gates: int) -> int:
        """Legacy uniform costing (gates × cycles_per_gate) — the paper's
        clock-scaled convention.  Prefer ``op_throughput_cycles`` with the
        per-basis cycle count from ``ir.op_cost(..., basis=self.basis)``."""
        return gates * self.cycles_per_gate

    def op_throughput(self, gates: int) -> float:
        """Vectored ops/second at full occupancy (paper §3)."""
        return self.total_rows * self.clock_hz / self.op_latency_cycles(gates)

    def op_throughput_cycles(self, cycles: int) -> float:
        """Vectored ops/second given a per-basis command-cycle count (the
        independently derived DRAM path; replaces clock-scaled parity)."""
        return self.total_rows * self.clock_hz / cycles

    def report_throughput(self, report) -> float:
        """Vectored dispatches/second from an ``ir.CostReport`` — works for
        single ops and fused multi-op programs alike, using the report's
        per-basis command cycles."""
        return self.op_throughput_cycles(report.cycles)

    def report_parallel_throughput(self, report) -> float:
        """Vectored dispatches/second if every dependency wave of the gate
        DAG fired in one command cycle (``CostReport.parallel_cycles`` =
        ``num_waves``) — the intra-array gate-parallelism bound the serial
        cycle count is compared against."""
        return self.op_throughput_cycles(max(report.parallel_cycles, 1))

    def report_hbm_bytes(self, report, n_elems: int) -> float:
        """HBM bytes one vectored dispatch moves: the report's boundary
        bit-planes × the packed plane size.  The metric multi-op fusion
        shrinks — intermediates of a fused program never cross this line."""
        return report.hbm_planes * n_elems / 8.0

    def op_throughput_per_watt(self, gates: int) -> float:
        return self.op_throughput(gates) / self.max_power_w

    def time_for_ops(self, n_ops: float, gates: int, rows_occupied: int | None = None) -> float:
        """Seconds to execute ``n_ops`` identical vectored ops."""
        rows = self.total_rows if rows_occupied is None else min(rows_occupied, self.total_rows)
        waves = -(-n_ops // rows) if n_ops > rows else 1
        return waves * self.op_latency_cycles(gates) / self.clock_hz


@dataclasses.dataclass(frozen=True)
class GPUConfig:
    name: str
    mem_bw: float  # bytes/s
    peak_fp32: float  # FLOP/s
    peak_fp16: float
    mem_bytes: int
    max_power_w: float
    link_bw: float  # NVLink bytes/s per GPU, all links, both directions

    def membound_throughput(self, bytes_per_op: int) -> float:
        return self.mem_bw / bytes_per_op

    def compute_throughput(self, flops_per_op: float = 1.0, fp16: bool = False) -> float:
        return (self.peak_fp16 if fp16 else self.peak_fp32) / flops_per_op


# --------------------------------------------------------------------- zoo
MEMRISTIVE_PIM = PIMConfig(
    name="memristive",
    crossbar_rows=1024,
    crossbar_cols=1024,
    mem_bytes=48 * GIB,
    gate_energy_j=6.4e-15,
    clock_hz=333e6,
)

DRAM_PIM = PIMConfig(
    name="dram",
    crossbar_rows=65536,
    crossbar_cols=1024,
    mem_bytes=48 * GIB,
    gate_energy_j=391e-15,
    clock_hz=0.5e6,
    basis="dram",
)

# NVIDIA RTX A6000 data sheet
# (https://www.nvidia.com/en-us/design-visualization/rtx-a6000/): the NVLink
# bridge joins two cards at 112.5 GB/s (bidirectional).
A6000 = GPUConfig(
    name="A6000",
    mem_bw=768e9,
    peak_fp32=38.7e12,
    peak_fp16=77.4e12,
    mem_bytes=48 * GIB,
    max_power_w=300.0,
    link_bw=112.5e9,
)

# NVIDIA A100 data sheet (https://www.nvidia.com/en-us/data-center/a100/):
# NVLink 600 GB/s (the PCIe part's bridge for two cards and the SXM part
# alike).
A100 = GPUConfig(
    name="A100",
    mem_bw=1935e9,
    peak_fp32=19.5e12,
    peak_fp16=312e12,
    mem_bytes=80 * GIB,
    max_power_w=300.0,
    link_bw=600e9,
)

# NVIDIA H100 SXM data sheet
# (https://www.nvidia.com/en-us/data-center/h100/): HBM3 bandwidth, FP32
# outside the tensor cores, dense bf16/fp16 tensor-core rate (the same
# convention as A100's 312e12), 80 GB, 700 W maximum power, NVLink 900 GB/s.
H100 = GPUConfig(
    name="H100",
    mem_bw=3.35e12,
    peak_fp32=67e12,
    peak_fp16=989e12,
    mem_bytes=80 * GIB,
    max_power_w=700.0,
    link_bw=900e9,
)

# Paper Fig 3 measured GPU throughputs (A6000, 32-bit ops), ops/s.
PAPER_GPU_MEASURED = {
    "fixed32_add": 0.057e12,
    "fixed32_mul": 0.057e12,
    "float32_add": 0.057e12,
    "float32_mul": 0.057e12,
}

# Gate counts back-solved from the paper's Fig 3 PIM throughputs (AritPIM's
# hand-optimized netlists).  Our own netlists (aritpim.gate_counts) are within
# 1.0–2.6x of these; both columns are reported by benchmarks/fig3_arith.py.
PAPER_GATE_COUNTS = {
    "fixed32_add": 288,  # 9N exactly — our netlist matches
    "fixed32_mul": 9059,
    "float32_add": 1995,
    "float32_mul": 5779,
}

# Paper Fig 3 PIM throughputs (ops/s) for direct assertion in tests.
PAPER_PIM_THROUGHPUT = {
    ("memristive", "fixed32_add"): 233e12,
    ("memristive", "fixed32_mul"): 7.4e12,
    ("memristive", "float32_add"): 33.6e12,
    ("memristive", "float32_mul"): 11.6e12,
    ("dram", "fixed32_add"): 0.35e12,
    ("dram", "fixed32_mul"): 0.01e12,
    ("dram", "float32_add"): 0.05e12,
    ("dram", "float32_mul"): 0.02e12,
}
