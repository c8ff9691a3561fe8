"""grok-1-314b [moe]: 64L d=6144 48H (GQA kv=8) ff=32768 v=131072;
8 experts top-2.  [hf:xai-org/grok-1; unverified]
EP note: 8 experts < 16-way model axis → expert weights shard d_ff
(moe_shard_mode="ffn"); memory plan requires FSDP (DESIGN.md §7).
long_500k: SKIP — full attention."""

import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=32768, vocab=131072,
    unit=("moe",), n_experts=8, n_shared_experts=0, top_k=2,
    moe_shard_mode="ffn",
)

SMOKE = dataclasses.replace(
    CONFIG, name="grok-1-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab=256, n_experts=4, top_k=2,
)
