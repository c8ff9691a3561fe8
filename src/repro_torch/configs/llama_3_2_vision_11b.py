"""llama-3.2-vision-11b [vlm]: 40L d=4096 32H (GQA kv=8) ff=14336 v=128256.

Cross-attention image layers every 5th layer (8 of 40); the vision frontend
is a stub — input_specs() supplies precomputed patch embeddings
[B, 1601, d_model] (1600 patches + CLS at 448px/14px patch).
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]
TP note: 32H/16-way model axis = 2 heads/shard (exact); kv=8 < 16 → GSPMD
replica-pads KV heads (documented waste, see EXPERIMENTS.md §Perf).
long_500k: SKIP — full attention (DESIGN.md §6)."""

import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=128256,
    unit=("global", "global", "global", "global", "cross"),
    rope_theta=500000.0, cross_kv_len=1601,
)

SMOKE = dataclasses.replace(
    CONFIG, name="llama-3.2-vision-smoke", n_layers=5, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab=256, cross_kv_len=16,
)
