"""PIM-offload analyzer — the paper's Fig 8 criterion as a framework feature.

For any workload (a measured training or inference step, or a hand-described
op stream) the analyzer computes

* the GPU-side three-term roofline time (compute, memory, NVLink),
* the modeled digital-PIM execution time (bit-serial element-parallel, with
  either our netlists' gate counts or the paper-calibrated ones),
* the paper's two axes — compute complexity of the dominant arithmetic and
  data reuse (FLOPs/byte) — and the resulting quadrant verdict.

The paper's conclusion (§6) reproduced as executable logic: **PIM wins only
when reuse is low or CC is low**; full-precision CNN/LM *training* (high CC ×
high reuse) stays on the accelerator, while memory-bound *decode* steps are
the PIM-friendly frontier (paper ref [13]).

The accelerator side is a :class:`~repro_torch.core.costmodel.GPUConfig`
(default the H100); its compute term is the dense 16-bit tensor-core rate,
the same one :func:`~repro_torch.core.metrics.machine_balance` divides, so
the reuse axis and ``pim_wins`` agree.
"""

from __future__ import annotations

import dataclasses

from .costmodel import H100, MEMRISTIVE_PIM, PAPER_GATE_COUNTS, GPUConfig, PIMConfig
from .metrics import compute_complexity, machine_balance


@dataclasses.dataclass(frozen=True)
class Workload:
    name: str
    flops: float  # global FLOPs per step (MAC = 2 FLOPs)
    hbm_bytes: float  # global accelerator HBM traffic per step
    collective_wire_bytes: float = 0.0  # per-device
    dtype_bits: int = 32

    @property
    def reuse(self) -> float:
        """Arithmetic intensity (paper §4's data-reuse axis)."""
        return self.flops / self.hbm_bytes if self.hbm_bytes else float("inf")


def netlist_gate_counts(nbits: int = 32) -> dict[str, int]:
    """Our own netlists' recorded gate counts, keyed like PAPER_GATE_COUNTS.

    Pulled from the ``repro_torch.core.ir`` compile cache (the cost backend),
    so the analyzer, ``simulate`` and the benchmarks all report from the same
    compilation path — pass the result as ``gate_counts=`` to ``analyze`` /
    ``pim_time`` to model our netlists instead of the paper-calibrated ones.
    """
    from . import ir

    return ir.netlist_gate_counts(nbits)


@dataclasses.dataclass(frozen=True)
class OffloadVerdict:
    workload: str
    gpu_time_s: float
    pim_time_s: float
    reuse: float
    cc: float
    reuse_is_low: bool
    cc_is_low: bool
    pim_wins: bool
    speedup: float  # gpu_time / pim_time (>1 ⇒ PIM faster)
    quadrant: str


def pim_time(
    w: Workload,
    pim: PIMConfig = MEMRISTIVE_PIM,
    gate_counts: dict[str, int] | None = None,
) -> float:
    """Bit-serial element-parallel time: FLOPs → add/mul pairs → gate-cycles.

    A MAC is one float add + one float mul; full row-parallel occupancy is
    assumed (upper bound, as in the paper's §5 methodology).

    For a config whose basis is not memristive (``DRAM_PIM``), the MAC cycle
    count is the program-level cost of the **fused** ``a*b + c`` compilation
    (``simulate.mac_cost`` → ``ir.compile_program``, MAJ3/NOT row commands)
    — one composed schedule whose intermediate product planes never leave
    the array, replacing both the paper's clock-scaled parity and the
    separate add+mul dispatch sum.  Passing explicit ``gate_counts`` (e.g.
    the paper-calibrated ones) forces the legacy gates × cycles_per_gate
    path."""
    n_mac = w.flops / 2.0
    if gate_counts is None and pim.basis != "memristive":
        from .simulate import mac_cost

        return n_mac * mac_cost(basis=pim.basis).cycles / (
            pim.total_rows * pim.clock_hz)
    g = gate_counts or PAPER_GATE_COUNTS
    total_gates = n_mac * (g["float32_add"] + g["float32_mul"])
    return total_gates * pim.cycles_per_gate / (pim.total_rows * pim.clock_hz)


def gpu_time(w: Workload, chips: int = 1, gpu: GPUConfig = H100) -> float:
    """The larger of compute at the dense 16-bit rate, HBM traffic and the
    per-device collective bytes over NVLink."""
    compute = w.flops / (chips * gpu.peak_fp16)
    memory = w.hbm_bytes / (chips * gpu.mem_bw)
    collective = w.collective_wire_bytes / gpu.link_bw
    return max(compute, memory, collective)


def analyze(
    w: Workload,
    chips: int = 1,
    pim: PIMConfig = MEMRISTIVE_PIM,
    gpu: GPUConfig = H100,
    gate_counts: dict[str, int] | None = None,
) -> OffloadVerdict:
    g = gate_counts or PAPER_GATE_COUNTS
    t_gpu = gpu_time(w, chips, gpu)
    # pass the *original* gate_counts so a non-memristive config takes the
    # basis-native cycle path (g here is only for the CC-axis thresholds)
    t_pim = pim_time(w, pim, gate_counts)
    # dominant arithmetic = fp MAC → mean CC of add+mul at the workload dtype
    cc = compute_complexity(g["float32_add"] + g["float32_mul"], 2 * 3 * w.dtype_bits)
    # thresholds from the paper: reuse is "low" below the machine balance
    # point (memory-bound on the accelerator); CC is "low" at fixed-add scale
    reuse_low = w.reuse < machine_balance(gpu)
    cc_low = cc <= 2 * compute_complexity(g["fixed32_add"], 3 * 32)
    quadrant = f"{'low' if cc_low else 'high'}-CC/{'low' if reuse_low else 'high'}-reuse"
    return OffloadVerdict(
        workload=w.name,
        gpu_time_s=t_gpu,
        pim_time_s=t_pim,
        reuse=w.reuse,
        cc=cc,
        reuse_is_low=reuse_low,
        cc_is_low=cc_low,
        pim_wins=t_pim < t_gpu,
        speedup=t_gpu / t_pim if t_pim else float("inf"),
        quadrant=quadrant,
    )
