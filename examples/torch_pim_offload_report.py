"""Beyond-paper showcase: the ConvPIM Fig-8 criterion applied to every
dry-run cell of the 10 assigned 2026-era LM architectures, against the H100.

Reads build/dryrun_torch/*.json (produced by ``repro_torch.launch.dryrun``)
and prints, per (arch × shape), the CC/reuse quadrant and whether the
modeled digital PIM beats the H100 roofline (data-sheet peaks, not
measured) — the paper's conclusion (training loses, memory-bound decode
wins) on modern workloads.

  PYTHONPATH=src python examples/torch_pim_offload_report.py [records_dir]
"""

import glob
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.core.analyzer import Workload, analyze  # noqa: E402
from repro_torch.core.costmodel import H100  # noqa: E402


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    directory = argv[0] if argv else "build/dryrun_torch"
    records = []
    for p in sorted(glob.glob(os.path.join(directory, "*__16x16.json"))):
        with open(p) as f:
            records.append(json.load(f))
    if not records:
        print(f"no dry-run records in {directory}; run repro_torch.launch.dryrun first")
        return []
    print(f"{'cell':44s} {'reuse':>9s} {'quadrant':22s} {'PIM?':5s} {'speedup':>8s}")
    wins, verdicts = 0, []
    for r in records:
        w = Workload(
            f'{r["arch"]}×{r["shape"]}',
            flops=r["flops_per_device"] * r["chips"],
            hbm_bytes=r["fused_bytes_per_device"] * r["chips"],
        )
        v = analyze(w, chips=r["chips"], gpu=H100)
        wins += v.pim_wins
        verdicts.append(v)
        print(f"{w.name:44s} {v.reuse:9.1f} {v.quadrant:22s} "
              f"{'WIN' if v.pim_wins else '-':5s} {v.speedup:8.2g}")
    print(f"\nPIM wins {wins}/{len(records)} cells — paper §6 predicts wins only in "
          "the low-reuse (decode) rows.")
    return verdicts


if __name__ == "__main__":
    main()
