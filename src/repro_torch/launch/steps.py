"""Step-function factories and analytic sizing shared by the train and
serve drivers.

Steps run eagerly: the train step takes the model (``nn.Module``), the
optimizer state and a batch, and updates the parameters in place.  Shapes
come from the ``meta`` device: building the model, its caches or its
optimizer state there allocates nothing, the port's counterpart of
``jax.eval_shape``.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.models import transformer as tfm
from repro_torch.optim import adafactor, adamw, clip_by_global_norm, warmup_cosine
from repro_torch.optim.adamw import apply_updates


def choose_optimizer(cfg: ModelConfig, name: str = "auto"):
    """Memory plan: models above 1e11 parameters train with Adafactor,
    everything else with AdamW.  Adafactor stacks each unit position's
    repeats as the reference does (``tfm.unit_stacks``)."""
    if name == "auto":
        name = "adafactor" if cfg.param_count() > 1e11 else "adamw"
    if name == "adamw":
        return name, adamw(lr=warmup_cosine(3e-4, 200, 10000), weight_decay=0.1)
    if name == "adamw-fast":
        # smoke/example scale: flat high lr, no decay
        return name, adamw(lr=3e-3, weight_decay=0.0)
    if name == "adafactor":
        return name, adafactor(lr=1e-2, stacks=tfm.unit_stacks(cfg))
    raise ValueError(name)


def loss_and_grads(params: tfm.Transformer, batch: dict, cfg: ModelConfig):
    """``loss_fn`` and its backward → (loss, metrics, grads), detached;
    grads by parameter name (zeros where a parameter took no part).  The
    ``.grad`` fields are left empty, so the caller owns the only copy."""
    params.zero_grad(set_to_none=True)
    loss, metrics = tfm.loss_fn(params, batch, cfg)
    loss.backward()
    grads = {}
    for k, p in params.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        if isinstance(g, DTensor):  # sum the data-parallel partial gradients once, as p is split
            g = g.redistribute(g.device_mesh, p.placements)
        grads[k] = g
        p.grad = None
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


class UpdateInterrupted(RuntimeError):
    """A train step failed after it began to update the moments or the
    parameters in place: the model and the optimizer state are partly
    updated, and only a checkpoint restores them."""


def make_train_step(cfg: ModelConfig, optimizer, *, grad_clip: float = 1.0):
    def train_step(params, opt_state, batch):
        loss, metrics, grads = loss_and_grads(params, batch, cfg)
        grads, gnorm = clip_by_global_norm(grads, grad_clip)
        named = dict(params.named_parameters())
        try:
            updates, opt_state = optimizer.update(grads, opt_state, named)
            del grads  # the clipped copy (4 B a parameter) goes before the updates are added
            apply_updates(named, updates)
        except RuntimeError as e:
            raise UpdateInterrupted(f"the update failed partway: {e}") from e
        return params, opt_state, {**metrics, "loss": loss, "grad_norm": gnorm}

    return train_step


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


def opt_state_shapes(optimizer, params_shapes: dict) -> dict:
    """The optimizer state for ``params_shapes`` (``meta`` tensors) as
    ``meta`` tensors — no allocation."""
    return optimizer.init(params_shapes)


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
