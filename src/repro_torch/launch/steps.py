"""Step-function factories and analytic sizing shared by the serving engine
(the serving half of the reference's ``launch/steps.py``).

Shapes come from the ``meta`` device: building the model or its caches
there allocates nothing, the port's counterpart of ``jax.eval_shape``.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.models import transformer as tfm


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, tokens, caches, cross_embeds=None):
        return tfm.prefill(params, tokens, cfg, caches, cross_embeds=cross_embeds)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(params, tokens, position, caches, cross_embeds=None):
        return tfm.decode_step(params, tokens, position, cfg, caches, cross_embeds=cross_embeds)

    return decode_step


def serve_config(cfg: ModelConfig) -> ModelConfig:
    """Serving runs with bf16 weights and no remat."""
    return dataclasses.replace(cfg, param_dtype="bfloat16", remat="none")


def param_shapes(cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """The parameters as ``meta`` tensors by ``state_dict`` name — no
    allocation."""
    return tfm.Transformer(cfg, device="meta").state_dict()


def cache_shapes(cfg: ModelConfig, batch: int, seq_len: int) -> list[dict]:
    return tfm.init_caches(cfg, batch, seq_len, device="meta")


def estimate_residency(
    cfg: ModelConfig,
    cell: ShapeCell,
    *,
    chips: int,
    model_par: int = 16,
    fsdp: bool,
    optimizer: str,
) -> dict:
    """Analytic per-device HBM residency (bytes), the reference's formula:
    parameters (2 bytes each when serving, sharded ``model_par`` ways or, with
    ``fsdp``, over every chip), optimizer state and gradients when training,
    KV/state caches when serving, and activations.  ``fits_16gb_hbm`` keeps
    the reference's 16 GB judgement."""
    n = cfg.param_count()
    pbytes = 4 if cell.kind == "train" else 2
    shard = chips if fsdp else model_par
    params = n * pbytes / shard
    out = {"params": params}
    if cell.kind == "train":
        opt_per_param = {"adamw": 8.0, "adafactor": 4.05}[optimizer]
        out["opt_state"] = n * opt_per_param / shard
        out["grads"] = n * 4 / shard
        tokens_dev = cell.global_batch * cell.seq_len / (chips / model_par)
        # full remat: saved unit inputs + logits/softmax slice
        out["activations"] = tokens_dev * cfg.d_model * 2 * cfg.n_layers / model_par
        out["logits"] = 3 * tokens_dev * cfg.vocab * 2 / model_par
    else:
        kv_layers = sum(1 for k in cfg.layer_kinds() if k in ("global", "moe"))
        loc_layers = sum(1 for k in cfg.layer_kinds() if k == "local")
        batch_dev = max(cell.global_batch / (chips / model_par), 1)
        kvh = max(cfg.n_kv_heads / model_par, 1)
        S = cell.seq_len
        cache = 2 * 2 * batch_dev * kvh * cfg.hd * (
            kv_layers * S + loc_layers * min(S, cfg.window)
        )
        ssm_layers = sum(1 for k in cfg.layer_kinds() if k == "ssm")
        rec_layers = sum(1 for k in cfg.layer_kinds() if k == "rec")
        cache += ssm_layers * batch_dev * (
            4 * max(cfg.n_ssm_heads / model_par, 1) * cfg.ssm_headdim * cfg.ssm_state
        )
        cache += rec_layers * batch_dev * 4 * max(cfg.lru_dim / model_par, 1)
        out["kv_or_state_cache"] = cache
        toks = cell.global_batch * (cell.seq_len if cell.kind == "prefill" else 1)
        out["activations"] = toks / max(chips / model_par, 1) * cfg.d_model * 2 * 4
    out["total"] = sum(out.values())
    out["fits_16gb_hbm"] = out["total"] < 16 * 1024**3
    return out


def model_flops_for_cell(cfg: ModelConfig, cell: ShapeCell) -> float:
    """MODEL_FLOPS per step: 6·N_active·D train, 2·N_active·D inference."""
    n = cfg.active_param_count()
    tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode" else 1)
    return (6.0 if cell.kind == "train" else 2.0) * n * tokens
