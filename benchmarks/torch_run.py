"""Benchmark harness of the PyTorch/CUDA port: one module per paper
table/figure.

  torch_fig3_arith      — §3 vectored arithmetic throughput/efficiency
  torch_fig4_cc         — §3 compute complexity vs improvement
  torch_fig_fused       — fused multi-op programs (MAC) vs separate dispatches
  torch_fig5_matmul     — §4 batched matmul reuse crossover
  torch_fig6_cnn_infer  — §5 CNN inference
  torch_fig7_cnn_train  — §5 CNN training

Prints ``name,us_per_call,derived`` CSV, on the card by default
(``--device cpu`` to run the plain versions on the CPU).  The reference's
``roofline_table`` is not ported yet: it reads the records of the dry run,
which comes with the port's scale-out slice.  The executor-mode shootout
(``torch_exec_modes``) is not part of the default sweep; ``--json PATH`` runs
only that benchmark (``--elems`` elements a dispatch) and writes its rows as
JSON: ``{"benchmark": "exec_modes", "device": ..., "elems": ..., "rows":
[...]}``.

    PYTHONPATH=src python -m benchmarks.torch_run [--json build/BENCH_exec_torch.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import traceback

import torch

from repro_torch.pim.frontend import resolve_device

from . import torch_exec_modes
from .torch_common import emit

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXEC_JSON = os.path.join(ROOT, "build", "BENCH_exec_torch.json")


def write_exec_json(path: str = EXEC_JSON, elems: int = torch_exec_modes.N_ELEMS,
                    device=None) -> list[dict]:
    """Run the executor-mode benchmark and write its rows to ``path``."""
    device = resolve_device(device)
    rows = torch_exec_modes.run(device=device, elems=elems)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"benchmark": "exec_modes", "device": name, "elems": elems,
                   "rows": rows}, f, indent=2, sort_keys=True)
        f.write("\n")
    emit([dict(r) for r in rows])
    return rows


def main(argv=None) -> None:
    parser = torch_exec_modes.add_elems_flag(
        argparse.ArgumentParser(description="ConvPIM benchmark harness (PyTorch/CUDA port)"))
    parser.add_argument(
        "--json", metavar="PATH", default=None,
        help="run only the executor-mode benchmark and write its rows "
             "(gates, num_cols, waves, us per executor mode) as JSON")
    parser.add_argument("--device", default=None,
                        help="torch device to run on (default: the CUDA card)")
    args = parser.parse_args(argv)

    if args.json is not None:
        write_exec_json(args.json, args.elems, args.device)
        return

    from . import (torch_fig3_arith, torch_fig4_cc, torch_fig5_matmul,
                   torch_fig6_cnn_infer, torch_fig7_cnn_train, torch_fig_fused)

    failures = 0
    for mod in (torch_fig3_arith, torch_fig4_cc, torch_fig_fused, torch_fig5_matmul,
                torch_fig6_cnn_infer, torch_fig7_cnn_train):
        try:
            emit(mod.run(device=args.device))
        except Exception:  # noqa: BLE001 — report every table, fail at the end
            failures += 1
            print(f"{mod.__name__},ERROR,", file=sys.stderr)
            traceback.print_exc()
    if failures:
        sys.exit(1)


if __name__ == "__main__":
    main()
