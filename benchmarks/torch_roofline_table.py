"""§Roofline table: collect the port's dry-run records into the per-cell
three-term table + the PIM-offload (Fig 8) verdict for every cell, in H100
terms.  The terms are modeled from data-sheet peaks (``core.costmodel.H100``:
989e12 dense bf16 FLOP/s, 3.35e12 B/s HBM, 900e9 B/s NVLink) and the
records' per-device counts; no time here is measured.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out build/dryrun_torch
  PYTHONPATH=src python -m benchmarks.torch_roofline_table
"""

from __future__ import annotations

import glob
import json
import os

from repro_torch.core.analyzer import Workload, analyze
from repro_torch.core.costmodel import H100

RESULTS = os.environ.get("DRYRUN_DIR", "build/dryrun_torch")


def load_records(directory: str = RESULTS) -> list[dict]:
    recs = []
    for path in sorted(glob.glob(os.path.join(directory, "*.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def _compute_term(r: dict) -> float:
    """Per-cell compute seconds: min(counted, walker) for dense; analytic
    (ideal × remat × capacity) for MoE, whose routing would inflate a
    compiler's op count."""
    ideal = r["model_flops"] / (r["chips"] * H100.peak_fp16)
    if "moe" in r["arch"] or "grok" in r["arch"]:
        return ideal * (1.33 * 1.25 if "train" in r["shape"] else 1.25)
    return min(r["flops_per_device"] / H100.peak_fp16, r["compute_s"])


def run(directory: str = RESULTS) -> list[dict]:
    rows = []
    for r in load_records(directory):
        if r["mesh"] != "16x16":
            continue  # the roofline table is single-pod
        w = Workload(
            f'{r["arch"]}×{r["shape"]}',
            flops=max(r["flops_per_device"], 1.0) * r["chips"],
            hbm_bytes=max(r["fused_bytes_per_device"], 1.0) * r["chips"],
            collective_wire_bytes=r["collective_wire_bytes_per_dev"],
        )
        v = analyze(w, chips=r["chips"], gpu=H100)
        comp = _compute_term(r)
        bound = max(comp, r["memory_s"], r["collective_s"])
        dom = "compute" if bound == comp else ("memory" if bound == r["memory_s"] else "collective")
        ideal = r["model_flops"] / (r["chips"] * H100.peak_fp16)
        rows.append({
            "name": f'roofline/{r["arch"]}__{r["shape"]}',
            "us_per_call": "",
            "compute_ms": f'{comp*1e3:.2f}',
            "memory_ms": f'{r["memory_s"]*1e3:.2f}',
            "collective_ms": f'{r["collective_s"]*1e3:.2f}',
            "dominant": dom,
            "mfu_at_bound": f'{ideal/bound:.1%}',
            "fits_hbm": str(r.get("residency", {}).get("fits_16gb_hbm", "?")),
            "pim_offload_quadrant": v.quadrant,
            "pim_wins": str(v.pim_wins),
        })
    if not rows:
        rows.append({"name": "roofline/none", "us_per_call": "",
                     "note": f"no records in {directory}; run repro_torch.launch.dryrun first"})
    return rows


def main():
    from .torch_common import emit

    emit(run())


if __name__ == "__main__":
    main()
