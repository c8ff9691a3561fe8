"""Quickstart of the PyTorch/CUDA port: the paper's core loop in one page.

1. Compile and run a fused element-wise PIM program (``repro_torch.pim``).
2. Price it on both logic bases and against separate dispatches.
3. Ask the Fig-8 analyzer where a workload should run, against the H100.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

It runs on the CUDA card by default (the f32 MAC on the loop kernel, in auto
mode); ``--device cpu`` runs the kernels' plain PyTorch versions.
"""

import argparse

import numpy as np

import repro_torch.pim as pim
from repro_torch.core import ir
from repro_torch.core.analyzer import Workload, analyze
from repro_torch.core.costmodel import DRAM_PIM, H100, MEMRISTIVE_PIM
from repro_torch.pim.frontend import resolve_device

WORKLOADS = (
    Workload("llm-decode bs=1 (3B params)", flops=2 * 3e9, hbm_bytes=2 * 3e9),
    Workload("llm-train 1M tokens (3B)", flops=6 * 3e9 * 1e6, hbm_bytes=60e9),
)


def main(argv=None) -> list:
    """Run the three steps and return the analyzer's verdicts."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device to run on (default: the CUDA card)")
    device = resolve_device(parser.parse_args(argv).device)

    # --- 1. trace-and-compile a fused MAC: one in-memory schedule, the
    #        intermediate product planes never round-trip through HBM
    rng = np.random.default_rng(0)
    x, y, c = (rng.standard_normal(1024).astype(np.float32) for _ in range(3))
    mac = pim.compile(lambda a, b, z: a * b + z, dtype=pim.f32)
    out = mac(x, y, c, device=device)
    exp = (x * y + c).astype(np.float32)
    if not (out.cpu().numpy().view(np.uint32) == exp.view(np.uint32)).all():
        raise SystemExit("fused f32 MAC differs from numpy")
    print(f"fused f32 MAC on {device}: bit-exact over {x.size} lanes")

    # --- 2. program-level cost vs separate dispatches, on both bases
    sep = [ir.op_cost("float_mul"), ir.op_cost("float_add")]
    for basis, cfg in (("memristive", MEMRISTIVE_PIM), ("dram", DRAM_PIM)):
        rep = mac.cost(basis=basis)
        print(f"{basis:11s} MAC: {rep.gates} gates, {rep.cycles} cycles, "
              f"peak {rep.peak_rows or rep.num_cols} rows, "
              f"{cfg.report_throughput(rep)/1e12:.3f} TMAC/s")
    print(f"HBM planes/dispatch: fused {mac.cost().hbm_planes} vs "
          f"separate mul+add {sum(r.hbm_planes for r in sep)} — "
          "the in-memory advantage the paper's Fig 3/8 story is about")

    # int8 MAC: the program's int8 result type means DCE deletes the dead
    # high product half that a full-width 2n-bit fixed_mul dispatch computes
    mac8 = pim.compile(lambda a, b, z: a * b + z, dtype=pim.int8)
    sep8 = sum(ir.op_cost(o, 8).gates for o in ("fixed_mul", "fixed_add"))
    print(f"int8 MAC gates: fused {mac8.cost().gates} vs full-width dispatches {sep8}; "
          f"HBM planes {mac8.cost().hbm_planes} vs 48")

    # --- 3. offload decision (paper Fig 8): CC × reuse quadrants, PIM
    #        against the H100 (data sheet rates)
    verdicts = []
    for w in WORKLOADS:
        v = analyze(w, gpu=H100)
        verdicts.append(v)
        print(f"{w.name:28s} reuse={v.reuse:9.1f} {v.quadrant:22s} "
              f"PIM {'WINS' if v.pim_wins else 'loses'} ({v.speedup:.2g}x vs H100)")
    return verdicts


if __name__ == "__main__":
    main()
