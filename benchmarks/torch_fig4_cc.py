"""Paper Fig 4 on the PyTorch/CUDA port: inverse relationship between
compute complexity and improvement over the memory-bound GPU.

I/O widths come from ``aritpim._OP_TABLE`` metadata (``op_io_bits``), not
from op-name string matching, and the DRAM columns are the independently
derived MAJ3/NOT compilation of each netlist (gate counts, AAP/TRA cycles,
peak rows) rather than clock-scaled memristive schedules.  The last column
sets the modeled PIM throughput against the H100's memory-bound rate for the
same op (``H100.mem_bw / io_bytes``, data sheet), where the reference has
the TPU v5e's.  The table is analytic: nothing runs on a device.

    PYTHONPATH=src python -m benchmarks.torch_fig4_cc
"""

from __future__ import annotations

from repro_torch.core import ir, metrics
from repro_torch.core.aritpim import op_io_bits
from repro_torch.core.costmodel import A6000, DRAM_PIM, H100, MEMRISTIVE_PIM, PAPER_GATE_COUNTS

from .torch_common import BASES, run_cli

# Fig-3/4 op name -> (aritpim._OP_TABLE key, nbits)
_FIG_OPS = {
    "fixed32_add": ("fixed_add", 32),
    "fixed32_mul": ("fixed_mul", 32),
    "float32_add": ("float_add", 32),
    "float32_mul": ("float_mul", 32),
}


def run(bases: tuple[str, ...] = BASES,
        passes: tuple[str, ...] | None = None, device=None) -> list[dict]:
    """Rows of Fig 4; ``device`` is accepted for the common CLI and unused."""
    rows = []
    passes = ir.DEFAULT_PASSES if passes is None else passes
    io_bits = {name: op_io_bits(key, nbits) for name, (key, nbits) in _FIG_OPS.items()}
    pts = metrics.fig4_points(MEMRISTIVE_PIM, A6000, PAPER_GATE_COUNTS, io_bits=io_bits)
    for p in sorted(pts, key=lambda q: q.cc):
        key, nbits = _FIG_OPS[p.op]
        # same CC axis, improvement vs the H100's HBM bound
        io_bytes = io_bits[p.op] // 8
        h100_membound = H100.mem_bw / io_bytes
        row = {
            "name": f"fig4/{p.op}",
            "us_per_call": "",
            "cc": f"{p.cc:.2f}",
            "pim_tops": f"{p.pim_throughput/1e12:.2f}",
        }
        if "dram" in bases:
            rep_dram = ir.op_cost(key, nbits, passes, basis="dram")
            dram_tops = DRAM_PIM.report_throughput(rep_dram)
            row.update({
                "dram_maj_gates": rep_dram.maj_gates,
                "dram_cycles": rep_dram.cycles,
                "dram_peak_rows": rep_dram.peak_rows,
                "dram_tops": f"{dram_tops/1e12:.4f}",
                "dram_improvement_vs_gpu_membound": (
                    f"{dram_tops/(A6000.membound_throughput(io_bytes)):.3f}x"
                ),
            })
        row.update({
            "improvement_vs_gpu_membound": f"{p.improvement:.1f}x",
            "improvement_vs_h100_membound": f"{p.pim_throughput/h100_membound:.1f}x",
        })
        rows.append(row)
    return rows


def main():
    run_cli(run)


if __name__ == "__main__":
    main()
