"""Architecture registry: the 10 assigned configs + reduced smoke variants.

Exact dims from the assignment brief, copied value for value from the
reference's arch files; each arch file's notes record TP divisibility and
long-context applicability."""

from __future__ import annotations

import importlib

ARCHS = [
    "llama_3_2_vision_11b",
    "deepseek_moe_16b",
    "grok_1_314b",
    "stablelm_3b",
    "llama3_2_3b",
    "gemma2_27b",
    "qwen2_5_14b",
    "mamba2_780m",
    "musicgen_large",
    "recurrentgemma_9b",
]


def _norm(name: str) -> str:
    """Map display names ('llama-3.2-vision-11b', 'qwen2.5-14b') to modules."""
    n = name.replace("-", "_").replace(".", "_")
    if n in ARCHS:
        return n
    for a in ARCHS:
        if n.replace("_", "") == a.replace("_", ""):
            return a
    raise KeyError(f"unknown arch {name!r}; known: {ARCHS}")


def get_config(name: str):
    return importlib.import_module(f"repro_torch.configs.{_norm(name)}").CONFIG


def get_smoke_config(name: str):
    """Reduced same-family config: small dims, few layers/experts — runs a
    forward/decode step on the CPU."""
    return importlib.import_module(f"repro_torch.configs.{_norm(name)}").SMOKE


def all_configs():
    return {a: get_config(a) for a in ARCHS}
