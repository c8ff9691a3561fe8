"""mamba2-780m [ssm]: 48L d=1536, attention-free, v=50280, ssm_state=128;
SSD (state-space duality).  [arXiv:2405.21060; unverified]
d_inner=3072, headdim=64 → 48 SSD heads.  long_500k: RUNS — O(1) decode
state; this is the paper's best-case workload (matrix-vector, no reuse)."""

import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab=50280,
    unit=("ssm",), ssm_state=128, ssm_headdim=64, ssm_expand=2,
    ssm_chunk=128, supports_long_context=True, mlp_gated=False,
)

SMOKE = dataclasses.replace(
    CONFIG, name="mamba2-smoke", n_layers=2, d_model=64, vocab=256,
    ssm_state=16, ssm_headdim=16, ssm_chunk=8,
)
