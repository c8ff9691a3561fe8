"""musicgen-large [audio]: 48L d=2048 32H (kv=32, MHA) ff=8192 v=2048;
decoder-only over EnCodec tokens.  [arXiv:2306.05284; hf]
The EnCodec frontend is a stub: the model consumes codec token ids directly
(vocab=2048); non-gated GELU FFN (standard transformer FFN, as in MusicGen).
long_500k: SKIP — full attention."""

import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=2048, mlp_gated=False, act="gelu",
)

SMOKE = dataclasses.replace(
    CONFIG, name="musicgen-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab=64,
)
