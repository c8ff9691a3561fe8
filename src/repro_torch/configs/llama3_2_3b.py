"""llama3.2-3b [dense]: 28L d=3072 24H (GQA kv=8) ff=8192 v=128256.
[hf:meta-llama/Llama-3.2-1B; unverified]
TP note: 24H % 16 != 0 → GSPMD pads heads to 32 under 16-way TP (25% pad on
attention only; hillclimb candidate: 8-way head × 2-way d_ff factoring).
long_500k: SKIP — full attention."""

import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b", family="dense",
    n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8,
    d_ff=8192, vocab=128256, rope_theta=500000.0,
)

SMOKE = dataclasses.replace(
    CONFIG, name="llama3.2-smoke", n_layers=2, d_model=48, n_heads=6,
    n_kv_heads=2, d_ff=96, vocab=256,
)
