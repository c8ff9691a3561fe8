"""Benchmark smoke of the PyTorch/CUDA port: run the compiler-facing tables
end to end, fail loudly.

Running the Fig 3, Fig 4, fused-MAC and Fig 5 tables exercises the whole
compiler pipeline (both logic bases, single-op and fused multi-op programs)
and, on the card, the matmul kernel, so it catches silent rot — an op that
stops compiling, a basis whose columns go missing, a table that comes back
empty — without asserting any particular performance number.  The
compile-cache hit/miss counters are printed at the end so cache regressions
are visible in the log.

One performance number *is* asserted: the executor-mode benchmark
(``torch_exec_modes``, written as JSON to ``--json``, by default
``build/BENCH_exec_torch.json``) must show the ``cuda-unrolled`` straight-line
kernel beating the ``cuda-loop`` kernel on the f32 fused MAC, at ``--elems``
elements a dispatch (default 4096).

Usage: ``PYTHONPATH=src python -m benchmarks.torch_smoke [--elems N]``
(exits non-zero on any exception, empty table, row with missing values, or
executor perf regression).
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.core import ir

from . import (torch_exec_modes, torch_fig3_arith, torch_fig4_cc, torch_fig5_matmul,
               torch_fig_fused)
from .torch_common import emit
from .torch_run import EXEC_JSON, write_exec_json

# Columns every row of each table must carry a non-empty value for.
_REQUIRED = {
    "fig3_arith": ("gates_recorded", "dram_maj_gates", "dram_cycles",
                   "dram_peak_rows", "memristive_tops_ours", "dram_tops_ours",
                   "parallel_cycles", "cols_peak_unsched"),
    "fig4_cc": ("cc", "pim_tops", "dram_cycles", "improvement_vs_gpu_membound"),
    "fig5_matmul": ("reuse_flops_per_byte", "pim_pairs_per_s",
                    "memristive_fusedmac_pairs_per_s", "dram_fusedmac_pairs_per_s",
                    "h100_membound_pairs_per_s"),
    "fig_fused": ("memristive_gates_fused", "memristive_gates_separate",
                  "memristive_hbm_planes_fused", "dram_cycles_fused",
                  "dram_hbm_planes_separate", "memristive_macs_per_s",
                  "hbm_bytes_fused", "memristive_parallel_cycles_fused",
                  "memristive_peak_cols_unsched"),
}


def check(name: str, rows: list[dict]) -> None:
    if not rows:
        raise SystemExit(f"smoke: {name} produced no rows")
    for row in rows:
        for col in _REQUIRED[name]:
            if row.get(col) in (None, ""):
                raise SystemExit(f"smoke: {name} row {row.get('name')} missing {col!r}")
    print(f"smoke: {name} ok ({len(rows)} rows)", file=sys.stderr)


def f32_mac_times(rows: list[dict]) -> tuple[float, float]:
    """(loop, straight-line) µs per call of the f32 MAC, memristive."""
    us = {r["name"]: float(r["us_per_call"]) for r in rows}
    loop = us.get("exec/f32_mac/memristive/cuda-loop")
    unrolled = us.get("exec/f32_mac/memristive/cuda-unrolled")
    if loop is None or unrolled is None:
        raise SystemExit("smoke: exec_modes is missing the f32 MAC rows")
    return loop, unrolled


def check_exec(rows: list[dict]) -> None:
    """The straight-line kernel must beat the loop kernel on the f32 MAC."""
    loop, unrolled = f32_mac_times(rows)
    if unrolled >= loop:
        raise SystemExit(
            f"smoke: cuda-unrolled ({unrolled:.0f}us) is not faster than "
            f"the loop kernel ({loop:.0f}us) on the f32 fused MAC")
    print(f"smoke: exec ok (f32 MAC unrolled {unrolled:.0f}us vs "
          f"loop {loop:.0f}us, {loop / unrolled:.1f}x)", file=sys.stderr)


def main(argv=None) -> None:
    parser = torch_exec_modes.add_elems_flag(
        argparse.ArgumentParser(description="ConvPIM benchmark smoke (PyTorch/CUDA port)"))
    parser.add_argument("--json", metavar="PATH", default=EXEC_JSON,
                        help="where to write the executor-mode rows "
                             "(default build/BENCH_exec_torch.json)")
    parser.add_argument("--device", default=None,
                        help="torch device to run on (default: the CUDA card)")
    args = parser.parse_args(argv)

    for name, mod in (("fig3_arith", torch_fig3_arith), ("fig4_cc", torch_fig4_cc),
                      ("fig_fused", torch_fig_fused), ("fig5_matmul", torch_fig5_matmul)):
        rows = mod.run(device=args.device)
        check(name, rows)
        emit(rows)
    check_exec(write_exec_json(args.json, args.elems, args.device))
    stats = ir.cache_stats()
    print(f"smoke: compile cache hits={stats['hits']} misses={stats['misses']}",
          file=sys.stderr)


if __name__ == "__main__":
    main()
