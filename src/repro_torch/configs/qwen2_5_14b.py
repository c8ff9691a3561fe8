"""qwen2.5-14b [dense]: 48L d=5120 40H (GQA kv=8) ff=13824 v=152064;
QKV bias.  [hf:Qwen/Qwen2.5-0.5B; hf]
TP note: 40H % 16 != 0 → GSPMD pads heads to 48 under 16-way TP (20% pad,
attention only).  long_500k: SKIP — full attention."""

import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b", family="dense",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=13824, vocab=152064, qkv_bias=True, rope_theta=1000000.0,
)

SMOKE = dataclasses.replace(
    CONFIG, name="qwen2.5-smoke", n_layers=2, d_model=80, n_heads=5,
    n_kv_heads=1, d_ff=160, vocab=256,
)
