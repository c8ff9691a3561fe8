"""Paper Fig 3 on the PyTorch/CUDA port: throughput + energy efficiency of
vectored arithmetic.

Columns per op: our recorded netlist gates, the post-pipeline optimized gate
count and peak live columns from the ``repro_torch.core.ir`` compiler (one compile
cache shared with kernels/simulate), paper-calibrated gates, modeled PIM
throughput (memristive/DRAM, ours + paper), GPU measured/theoretical from
the paper, and the H100's memory-bound and peak equivalents (data sheet).  Beyond
the paper's 32-bit set, the multi-precision rows (int8/int16 fixed, bf16
float) quantify the paper's bit-serial scaling argument: gates fall
superlinearly with precision.

The DRAM rows are *independently derived* from the ``dram``-basis
compilation of the same netlists — MAJ3/NOT gate counts, AAP/TRA
row-command cycles and peak rows (including the reserved compute-row
group) — no longer the paper's clock-scaled memristive schedules; the
clock-scaled figure is kept as ``dram_tops_clock_scaled`` for comparison.

The us_per_call column times the bit-exact simulation (execute-mode PlaneVM,
one PyTorch op per gate, on the card by default or on ``--device cpu``) —
correctness time, not the modeled hardware number.

    PYTHONPATH=src python -m benchmarks.torch_fig3_arith [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import ir, simulate
from repro_torch.core.costmodel import (
    A6000,
    DRAM_PIM,
    H100,
    MEMRISTIVE_PIM,
    PAPER_GATE_COUNTS,
    PAPER_GPU_MEASURED,
    PAPER_PIM_THROUGHPUT,
)
from repro_torch.pim.frontend import resolve_device

from .torch_common import BASES, run_cli, time_fn

N_ELEMS = 4096

# name -> (sim fn(x, y, device), ir op key, nbits, input kind)
_OPS = {
    "fixed8_add": (lambda x, y, d: simulate.fixed_add(x, y, nbits=8, device=d)[0],
                   "fixed_add", 8, "int8"),
    "fixed8_mul": (lambda x, y, d: simulate.fixed_mul(x, y, nbits=8, device=d)[0],
                   "fixed_mul", 8, "int8"),
    "fixed16_add": (lambda x, y, d: simulate.fixed_add(x, y, nbits=16, device=d)[0],
                    "fixed_add", 16, "int16"),
    "fixed16_mul": (lambda x, y, d: simulate.fixed_mul(x, y, nbits=16, device=d)[0],
                    "fixed_mul", 16, "int16"),
    "fixed32_add": (lambda x, y, d: simulate.fixed_add(x, y, device=d)[0],
                    "fixed_add", 32, "int32"),
    "fixed32_mul": (lambda x, y, d: simulate.fixed_mul(x, y, device=d)[0],
                    "fixed_mul", 32, "int32"),
    "bf16_add": (lambda x, y, d: simulate.bf16_add(x, y, device=d)[0], "bf16_add", 16, "bf16"),
    "bf16_mul": (lambda x, y, d: simulate.bf16_mul(x, y, device=d)[0], "bf16_mul", 16, "bf16"),
    "float32_add": (lambda x, y, d: simulate.float_add(x, y, device=d)[0], "float_add", 32, "f32"),
    "float32_mul": (lambda x, y, d: simulate.float_mul(x, y, device=d)[0], "float_mul", 32, "f32"),
    "float32_div": (lambda x, y, d: simulate.float_div(x, y, device=d)[0], "float_div", 32, "f32"),
}


def _inputs(kind: str, rng: np.random.Generator, device: torch.device):
    if kind.startswith("int"):
        nbits = int(kind[3:])
        lo, hi = -(2 ** (nbits - 1)), 2 ** (nbits - 1)
        x = rng.integers(lo, hi, N_ELEMS, dtype=np.int64).astype(np.int32)
        y = rng.integers(lo, hi, N_ELEMS, dtype=np.int64).astype(np.int32)
        return torch.as_tensor(x, device=device), torch.as_tensor(y, device=device)
    x = rng.standard_normal(N_ELEMS).astype(np.float32)
    y = rng.standard_normal(N_ELEMS).astype(np.float32)
    x, y = torch.as_tensor(x, device=device), torch.as_tensor(y, device=device)
    if kind == "bf16":
        return x.to(torch.bfloat16), y.to(torch.bfloat16)
    return x, y


def run(bases: tuple[str, ...] = BASES,
        passes: tuple[str, ...] | None = None, device=None) -> list[dict]:
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    passes = ir.DEFAULT_PASSES if passes is None else passes
    rows = []
    for op, (sim, ir_key, nbits, kind) in _OPS.items():
        x, y = _inputs(kind, rng, device)
        rep = ir.op_cost(ir_key, nbits, passes)  # warm the cache before timing
        # eager bit-exact simulation; the column is correctness time, not
        # modeled hardware time
        us = time_fn(sim, x, y, device, device=device, warmup=0, iters=1)
        ours = rep.recorded_gates
        paper = PAPER_GATE_COUNTS.get(op)  # None for ops with no Fig-3 reference
        bytes_per_op = 3 * (nbits // 8)  # 2 reads + 1 write
        # the same pipeline minus the pressure scheduler, to show its win
        unsched = tuple(p for p in passes if p != "reorder")
        rep_unsched = ir.op_cost(ir_key, nbits, unsched)
        row = {
            "name": f"fig3/{op}",
            "us_per_call": f"{us:.0f}",
            "gates_recorded": ours,
            "gates_optimized": rep.gates,  # post-pipeline (≤ recorded)
            "cols_peak": rep.num_cols,  # ≤ the 1024-column crossbar budget
            "cols_peak_unsched": rep_unsched.num_cols,  # without `reorder`
            "parallel_cycles": rep.parallel_cycles,  # dependency waves
            "gates_paper": paper if paper is not None else "n/a",
        }
        if "memristive" in bases:
            row.update({
                "memristive_tops_ours": f"{MEMRISTIVE_PIM.op_throughput(ours)/1e12:.2f}",
                "memristive_tops_optimized": f"{MEMRISTIVE_PIM.op_throughput(rep.gates)/1e12:.2f}",
                # upper bound if every dependency wave fired in one cycle
                "memristive_tops_parallel":
                    f"{MEMRISTIVE_PIM.report_parallel_throughput(rep)/1e12:.2f}",
                "memristive_tops_paper_model": (
                    f"{MEMRISTIVE_PIM.op_throughput(paper)/1e12:.2f}"
                    if paper is not None else "n/a"
                ),
                "memristive_tops_paper_fig3": (
                    f"{PAPER_PIM_THROUGHPUT[('memristive', op)]/1e12:.2f}"
                    if ('memristive', op) in PAPER_PIM_THROUGHPUT else "n/a"
                ),
            })
        if "dram" in bases:
            # independently derived dram-basis columns (MAJ3/NOT lowering)
            rep_dram = ir.op_cost(ir_key, nbits, passes, basis="dram")
            row.update({
                "dram_maj_gates": rep_dram.maj_gates,
                "dram_not_gates": rep_dram.not_gates,
                "dram_cycles": rep_dram.cycles,
                "dram_peak_rows": rep_dram.peak_rows,
                "dram_tops_ours": f"{DRAM_PIM.report_throughput(rep_dram)/1e12:.4f}",
                "dram_tops_clock_scaled": f"{DRAM_PIM.op_throughput(ours)/1e12:.4f}",
                "dram_tops_paper_fig3": (
                    f"{PAPER_PIM_THROUGHPUT[('dram', op)]/1e12:.4f}"
                    if ('dram', op) in PAPER_PIM_THROUGHPUT else "n/a"
                ),
            })
        row.update({
            "gpu_measured_tops": f"{PAPER_GPU_MEASURED.get(op, 0.057e12)/1e12:.3f}",
            "gpu_theoretical_tops": f"{A6000.compute_throughput()/1e12:.1f}",
            "h100_membound_tops": f"{H100.mem_bw/bytes_per_op/1e12:.3f}",
            "h100_peak_tops": f"{H100.peak_fp16/1e12:.0f}",
            "memr_tops_per_w_ours": f"{MEMRISTIVE_PIM.op_throughput_per_watt(ours)/1e9:.2f}G",
            "gpu_membound_per_w": f"{PAPER_GPU_MEASURED.get(op, 0.057e12)/A6000.max_power_w/1e9:.3f}G",
        })
        rows.append(row)
    return rows


def main():
    run_cli(run)


if __name__ == "__main__":
    main()
