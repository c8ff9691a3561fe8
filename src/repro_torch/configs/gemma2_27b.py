"""gemma2-27b [dense]: 46L d=4608 32H (GQA kv=16) ff=36864 v=256000;
local(4096)+global alternating, attn softcap 50, final softcap 30, tied
embeddings.  [arXiv:2408.00118; hf]
long_500k: SKIP — the global layers are full attention at 500k
(local-only layers would qualify, the arch as a whole does not)."""

import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b", family="dense",
    n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16,
    d_ff=36864, vocab=256000, head_dim=128,
    unit=("local", "global"), window=4096,
    attn_softcap=50.0, final_softcap=30.0, tie_embeddings=True, act="gelu",
)

SMOKE = dataclasses.replace(
    CONFIG, name="gemma2-smoke", n_layers=4, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab=256, head_dim=16, window=8,
)
