"""stablelm-3b [dense]: 32L d=2560 32H (kv=32, MHA) ff=6912 v=50304.
[hf:stabilityai/stablelm-2-1_6b; unverified]
TP note: 32H/16 = 2 heads/shard exact; vocab 50304 = 16·3144 exact.
long_500k: SKIP — full attention."""

import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b", family="dense",
    n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=6912, vocab=50304,
)

SMOKE = dataclasses.replace(
    CONFIG, name="stablelm-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab=256,
)
