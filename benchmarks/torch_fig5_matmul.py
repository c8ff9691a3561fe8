"""Paper Fig 5 on the PyTorch/CUDA port: batched n×n fp32 matrix
multiplication — PIM vs GPU, as data reuse O(n) grows.

Reproduces the paper's crossover: for small n the GPU is memory-bound and
PIM competes; by n≈128 reuse lifts the GPU to compute-bound and PIM loses
(paper §4).  The GPU columns are the paper's A6000 and the H100 this port
runs on (``h100_*``, from the data sheet).  The us_per_call column times
the port's MatPIM-schedule CUDA kernel (``ops.pim_matmul_op``) on a
``[2,128,128]`` float32 instance, on the card by default.

    PYTHONPATH=src python -m benchmarks.torch_fig5_matmul [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import ir
from repro_torch.core.costmodel import (
    A6000,
    DRAM_PIM,
    H100,
    MEMRISTIVE_PIM,
    PAPER_GATE_COUNTS,
)
from repro_torch.core.simulate import mac_cost
from repro_torch.kernels import ops
from repro_torch.pim.frontend import resolve_device

from .torch_common import BASES, run_cli, time_fn

SIZES = (16, 32, 64, 128, 256, 512)


def pim_matmul_time(n: int, pim=MEMRISTIVE_PIM, gates=PAPER_GATE_COUNTS,
                    mac_cycles: int | None = None) -> float:
    """MatPIM: n² dot products of length n per matrix pair, bit-serial
    element-parallel → per-pair work = n³ MACs; rows hold matrix pairs.

    ``mac_cycles`` prices one MAC from a compiled program (e.g. the fused
    ``a*b+c`` schedule on the config's own basis); the default is the
    paper-calibrated gates × cycles_per_gate convention."""
    macs = n**3
    if mac_cycles is None:
        mac_cycles = (gates["float32_add"] + gates["float32_mul"]) * pim.cycles_per_gate
    # one pair occupies n rows (row-parallel rank-1 updates over n steps)
    pairs_parallel = pim.total_rows / n
    cycles = macs / n * mac_cycles  # n-way row parallel per pair
    return cycles / pim.clock_hz / pairs_parallel  # seconds per pair at full occupancy


def run(bases: tuple[str, ...] = BASES,
        passes: tuple[str, ...] | None = None, device=None) -> list[dict]:
    device = resolve_device(device)
    rows = []
    rng = np.random.default_rng(0)
    a = torch.as_tensor(rng.normal(size=(2, 128, 128)), dtype=torch.float32, device=device)
    b = torch.as_tensor(rng.normal(size=(2, 128, 128)), dtype=torch.float32, device=device)
    kernel_us = time_fn(lambda x, y: ops.pim_matmul_op(x, y, device=device), a, b,
                        device=device, warmup=1, iters=2)
    passes = ir.DEFAULT_PASSES if passes is None else passes

    for n in SIZES:
        flops = 2 * n**3
        bytes_ = 3 * n * n * 4
        t_pim = pim_matmul_time(n)
        t_gpu_mem = bytes_ / A6000.mem_bw
        t_gpu_comp = flops / A6000.peak_fp32
        t_h100_mem = bytes_ / H100.mem_bw
        t_h100_comp = flops / H100.peak_fp32
        pim_tput = 1.0 / t_pim
        row = {
            "name": f"fig5/matmul_n{n}",
            "us_per_call": f"{kernel_us:.0f}" if n == 128 else "",
            "reuse_flops_per_byte": f"{flops/bytes_:.1f}",
            "pim_pairs_per_s": f"{pim_tput:.3g}",
        }
        # per-basis columns from the fused-MAC compiled schedule (one
        # compile per basis, then cached)
        for basis, cfg in (("memristive", MEMRISTIVE_PIM), ("dram", DRAM_PIM)):
            if basis not in bases:
                continue
            t = pim_matmul_time(
                n, cfg, mac_cycles=mac_cost(basis=basis, passes=passes).cycles)
            row[f"{basis}_fusedmac_pairs_per_s"] = f"{1/t:.3g}"
        row.update({
            "gpu_membound_pairs_per_s": f"{1/t_gpu_mem:.3g}",
            "gpu_computebound_pairs_per_s": f"{1/t_gpu_comp:.3g}",
            "h100_membound_pairs_per_s": f"{1/t_h100_mem:.3g}",
            "h100_computebound_pairs_per_s": f"{1/t_h100_comp:.3g}",
            "pim_beats_gpu_exp": str(t_pim < max(t_gpu_mem, t_gpu_comp)),
            "pim_eff_per_w": f"{pim_tput/MEMRISTIVE_PIM.max_power_w:.3g}",
            "gpu_eff_per_w": f"{1/max(t_gpu_mem, t_gpu_comp)/A6000.max_power_w:.3g}",
        })
        rows.append(row)
    return rows


def main():
    run_cli(run)


if __name__ == "__main__":
    main()
