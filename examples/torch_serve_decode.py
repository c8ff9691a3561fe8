"""Batched serving with the PyTorch/CUDA port: prefill + decode with the
gemma2-family smoke model, plus the PIM-offload verdict for the decode
phase — the paper's §6 observation (memory-bound decode is PIM territory),
here against the H100.

  PYTHONPATH=src python examples/torch_serve_decode.py [--device cpu]

It serves on the CUDA card by default; ``--device cpu`` serves on the CPU.
"""

import argparse

import numpy as np

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.analyzer import Workload, analyze
from repro_torch.launch.serve import ServeEngine


def main(argv=None):
    """Serve four prompts and return (tokens [4, 40], the Fig 8 verdict)."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device to serve on (default: the CUDA card)")
    args = parser.parse_args(argv)

    cfg = get_smoke_config("gemma2_27b")
    engine = ServeEngine.build(cfg, max_seq=48, device=args.device)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32)
    out = engine.generate(prompts, 24, temperature=0.8)
    print(f"[serve] generated {out.shape[0]} sequences × {out.shape[1]} tokens "
          f"on {engine.device}")
    for row in out[:2]:
        print("  ", row[-24:].tolist())

    # the paper's Fig-8 verdict for the FULL gemma2-27b decode step
    full = get_config("gemma2_27b")
    n = full.param_count()
    w = Workload(
        "gemma2-27b decode bs=128", flops=2 * n * 128, hbm_bytes=2 * n + 128 * 2e6
    )
    v = analyze(w)
    print(f"[analyzer] {w.name}: reuse={v.reuse:.1f} FLOP/B, {v.quadrant}, "
          f"PIM {'WINS' if v.pim_wins else 'loses'} ({v.speedup:.2g}×) against the "
          f"H100's modeled {v.gpu_time_s * 1e3:.2f} ms")
    return out, v


if __name__ == "__main__":
    main()
