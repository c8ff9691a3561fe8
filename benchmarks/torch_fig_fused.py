"""Fused multi-op programs vs separate dispatches — the in-memory payoff, on
the PyTorch/CUDA port.

The paper's core claim is that digital PIM wins exactly when intermediate
results stay in the array (Fig 3/Fig 8).  This table quantifies it with the
``repro_torch.pim`` trace-and-compile frontend: the fused MAC ``a*b + c`` compiled
as **one** schedule vs separate ``mul`` then ``add`` dispatches whose
product planes round-trip through HBM.  Per dtype and basis it reports

* native gates and per-basis command cycles, fused vs the separate-dispatch
  sum.  The separate baseline is what the public wrappers actually dispatch
  (for fixed point that is the *truncated* low-half product program, so the
  gate comparison isolates true cross-op fusion wins from the truncation
  win; the legacy full-width ``_OP_TABLE`` dispatch is kept as
  ``*_separate_fullwidth`` for fixed rows),
* peak live columns/rows vs the paper's 1024 budget, and
* HBM traffic — plane counts and bytes (``PIMConfig.report_hbm_bytes``):
  the fused program moves only its true inputs and outputs, never the
  intermediate product planes.

``us_per_call`` times the fused interpreter execution on 4096 elements
(the per-gate PyTorch walk, on the card by default or on ``--device cpu``).

    PYTHONPATH=src python -m benchmarks.torch_fig_fused [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

import repro_torch.pim as pim
from repro_torch.core import ir
from repro_torch.core.costmodel import DRAM_PIM, MEMRISTIVE_PIM
from repro_torch.pim.frontend import resolve_device

from .torch_common import BASES, run_cli, time_fn

N_ELEMS = 4096

# row name -> (PimType, full-width _OP_TABLE keys + nbits for fixed rows)
_CASES = {
    "f32_mac": (pim.f32, None),
    "bf16_mac": (pim.bf16, None),
    "int16_mac": (pim.int16, (("fixed_mul", "fixed_add"), 16)),
    "int8_mac": (pim.int8, (("fixed_mul", "fixed_add"), 8)),
}

_CONFIGS = {"memristive": MEMRISTIVE_PIM, "dram": DRAM_PIM}


def _inputs(dtype, rng, device):
    if dtype.kind == "fixed":
        lo, hi = -(2 ** (dtype.nbits - 1)), 2 ** (dtype.nbits - 1)
        return tuple(
            torch.as_tensor(rng.integers(lo, hi, N_ELEMS).astype(np.int32), device=device)
            for _ in range(3)
        )
    xs = tuple(torch.as_tensor(rng.standard_normal(N_ELEMS).astype(np.float32),
                               device=device) for _ in range(3))
    if dtype.kind == "bf16":
        return tuple(x.to(torch.bfloat16) for x in xs)
    return xs


def run(bases: tuple[str, ...] = BASES,
        passes: tuple[str, ...] | None = None, device=None) -> list[dict]:
    device = resolve_device(device)
    passes = ir.DEFAULT_PASSES if passes is None else passes
    rng = np.random.default_rng(0)
    rows = []
    for name, (dtype, fullwidth) in _CASES.items():
        mac = pim.compile(lambda a, b, c: a * b + c, dtype=dtype)
        # what separate dispatches through the public wrappers actually run
        sep_mul = pim.compile(lambda a, b: a * b, dtype=dtype)
        sep_add = pim.compile(lambda a, b: a + b, dtype=dtype)
        x, y, c = _inputs(dtype, rng, device)
        mac.compiled(passes=passes)  # warm the cache before timing
        us = time_fn(
            lambda: mac(x, y, c, passes=passes, backend="interpreter", device=device),
            device=device, warmup=0, iters=1)
        fused_mem = mac.cost(passes=passes)
        row = {
            "name": f"fig_fused/{name}",
            "us_per_call": f"{us:.0f}",
            "hbm_bytes_fused":
                f"{MEMRISTIVE_PIM.report_hbm_bytes(fused_mem, N_ELEMS):.0f}",
        }
        unsched = tuple(p for p in passes if p != "reorder")
        for basis in bases:
            fused = mac.cost(basis=basis, passes=passes)
            fused_unsched = mac.cost(basis=basis, passes=unsched)
            seps = [sep_mul.cost(basis=basis, passes=passes),
                    sep_add.cost(basis=basis, passes=passes)]
            cfg = _CONFIGS[basis]
            row.update({
                f"{basis}_gates_fused": fused.gates,
                f"{basis}_gates_separate": sum(r.gates for r in seps),
                f"{basis}_cycles_fused": fused.cycles,
                f"{basis}_cycles_separate": sum(r.cycles for r in seps),
                f"{basis}_parallel_cycles_fused": fused.parallel_cycles,
                f"{basis}_peak_cols_fused": fused.num_cols,
                f"{basis}_peak_cols_unsched": fused_unsched.num_cols,
                f"{basis}_peak_rows_fused": fused.peak_rows,
                f"{basis}_hbm_planes_fused": fused.hbm_planes,
                f"{basis}_hbm_planes_separate": sum(r.hbm_planes for r in seps),
                f"{basis}_hbm_saving":
                    f"{sum(r.hbm_planes for r in seps)/fused.hbm_planes:.2f}x",
                f"{basis}_macs_per_s": f"{cfg.report_throughput(fused)/1e12:.4f}T",
            })
            if fullwidth is not None:
                ops_keys, nbits = fullwidth
                full = sum(
                    ir.op_cost(k, nbits, passes, basis=basis).gates
                    for k in ops_keys)
                row[f"{basis}_gates_separate_fullwidth"] = full
        rows.append(row)
    return rows


def main():
    run_cli(run)


if __name__ == "__main__":
    main()
