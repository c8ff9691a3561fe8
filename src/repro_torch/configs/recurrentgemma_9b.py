"""recurrentgemma-9b [hybrid]: 38L d=4096 16H? (brief: GQA kv=1 → MQA)
ff=12288 v=256000; RG-LRU + local attn 1:2.  [arXiv:2402.19427; unverified]
Pattern (rec, rec, local)×12 + 2-layer tail (38 = 12·3 + 2).
long_500k: RUNS — bounded local window (2048) + O(1) RG-LRU state."""

import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
    d_ff=12288, vocab=256000, head_dim=256,
    unit=("rec", "rec", "local"), window=2048, lru_width=4096,
    tie_embeddings=True, act="gelu", supports_long_context=True,
)

SMOKE = dataclasses.replace(
    CONFIG, name="recurrentgemma-smoke", n_layers=5, d_model=64, n_heads=4,
    n_kv_heads=1, d_ff=128, vocab=256, head_dim=16, window=8, lru_width=64,
)
