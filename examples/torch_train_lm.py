"""End-to-end training with the PyTorch/CUDA port: a llama-family model on
the synthetic stream, with checkpointing and fault-tolerant restart.

Full run (a few hundred steps, ~100M params):
  PYTHONPATH=src python examples/torch_train_lm.py --d-model 512 --layers 12 \
      --steps 300 --batch 8 --seq 256

Quick run (trains on the CUDA card by default; ``--device cpu`` on the CPU):
  PYTHONPATH=src python examples/torch_train_lm.py --steps 20 [--device cpu]
"""

import argparse
import dataclasses

import numpy as np

from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import DataConfig, SyntheticStream
from repro_torch.launch.train import build_run, train_loop
from repro_torch.runtime.fault_tolerance import FTConfig


def main(argv=None):
    """Train and return the history (one dict per step: step, loss, time_s)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--vocab", type=int, default=8192)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: the CUDA card)")
    args = ap.parse_args(argv)

    base = get_smoke_config("llama3_2_3b")
    cfg = dataclasses.replace(
        base, name="train-lm-example", n_layers=args.layers, d_model=args.d_model,
        n_heads=max(4, args.d_model // 64), n_kv_heads=max(2, args.d_model // 128),
        d_ff=args.d_model * 4, vocab=args.vocab,
    )
    run = build_run(cfg, optimizer_name="adamw-fast", device=args.device)
    n = sum(p.numel() for p in run.params.parameters())
    device = next(run.params.parameters()).device
    print(f"[example] {cfg.name}: {n/1e6:.1f}M params, {args.steps} steps on {device}")
    stream = SyntheticStream(DataConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch, structure=0.85
    ))
    run, hist = train_loop(
        run, stream, args.steps, ckpt_dir=args.ckpt_dir,
        ft=FTConfig(checkpoint_every=50), log_every=10,
    )
    losses = [h["loss"] for h in hist]
    print(f"[example] loss: {losses[0]:.3f} → {losses[-1]:.3f} "
          f"(mean step {np.mean([h['time_s'] for h in hist])*1e3:.0f} ms)")
    if args.steps >= 50:  # too noisy to assert on shorter runs
        assert np.mean(losses[-10:]) < np.mean(losses[:10]), "training must make progress"
    return hist


if __name__ == "__main__":
    main()
