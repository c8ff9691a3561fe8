"""deepseek-moe-16b [moe]: 28L d=2048 16H (kv=16, MHA) ff=1408/expert
v=102400; 2 shared + 64 routed top-6 (fine-grained experts).
[arXiv:2401.06066; hf]
EP note: 64 experts / 16-way model axis = 4 experts/shard (exact).
long_500k: SKIP — full attention."""

import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=102400,
    unit=("moe",), n_experts=64, n_shared_experts=2, top_k=6,
    moe_shard_mode="expert",
)

SMOKE = dataclasses.replace(
    CONFIG, name="deepseek-moe-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=32, vocab=256, n_experts=8, top_k=2, n_shared_experts=1,
)
