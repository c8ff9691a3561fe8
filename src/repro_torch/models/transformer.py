"""Model assembly for all assigned families (dense/moe/ssm/hybrid/vlm/audio).

The model is a flat ``nn.ModuleList`` of per-layer modules in
``cfg.layer_kinds()`` order — the reference groups them into stacked
``units`` plus a ``tail`` for ``lax.scan``; ``repro_torch.convert.lm_params``
unstacks its trees into this order.  Every layer kind returns an optional
cache entry, so the same assembly serves training, prefill and decode.
``remat`` ("full" or "dots") checkpoints each layer of the repeating units
when gradients are taken (``torch.utils.checkpoint``, non-reentrant), as
the reference checkpoints its scanned unit; the tail layers, prefill and
decode run without it.  ``unroll_layers`` steers XLA's scan, which eager
PyTorch has not, and is ignored.
"""

from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.pim.frontend import resolve_device

from . import attention as attn_mod
from . import moe as moe_mod
from . import rglru as rglru_mod
from . import ssm as ssm_mod
from .layers import MLP, Embed, apply_mlp, embed_tokens, init_rms_norm, lm_head, pdtype, rms_norm
from . import spmd

ATTN_KINDS = ("global", "local", "cross", "moe")


# ------------------------------------------------------------------- init

class Layer(nn.Module):
    """One pre-norm residual block's parameters (the reference's
    ``init_layer``): attention kinds hold ``attn_norm``, ``attn``,
    ``mlp_norm`` and ``mlp`` (``moe`` for MoE layers); ``ssm`` layers
    ``norm`` and ``ssm``; ``rec`` layers ``norm``, ``rec``, ``mlp_norm`` and
    ``mlp``."""

    def __init__(self, kind: str, cfg: ModelConfig, *, device=None, generator=None):
        super().__init__()
        self.kind = kind
        d, dt, kw = cfg.d_model, pdtype(cfg), {"device": device, "generator": generator}
        if kind in ATTN_KINDS:
            self.attn_norm = init_rms_norm(d, dt, device)
            self.attn = attn_mod.Attention(cfg, **kw)
            self.mlp_norm = init_rms_norm(d, dt, device)
            if kind == "moe":
                self.moe = moe_mod.MoE(cfg, **kw)
            else:
                self.mlp = MLP(cfg, **kw)
        elif kind == "ssm":
            self.norm = init_rms_norm(d, dt, device)
            self.ssm = ssm_mod.SSM(cfg, **kw)
        elif kind == "rec":
            self.norm = init_rms_norm(d, dt, device)
            self.rec = rglru_mod.RGLRU(cfg, **kw)
            self.mlp_norm = init_rms_norm(d, dt, device)
            self.mlp = MLP(cfg, **kw)
        else:
            raise ValueError(kind)


class Transformer(nn.Module):
    """The whole model's parameters: ``embed``, ``layers`` (one
    :class:`Layer` per entry of ``cfg.layer_kinds()``) and ``final_norm``."""

    def __init__(self, cfg: ModelConfig, *, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        self.embed = Embed(cfg, device=device, generator=generator)
        self.layers = nn.ModuleList(Layer(kind, cfg, device=device, generator=generator)
                                    for kind in cfg.layer_kinds())
        self.final_norm = init_rms_norm(cfg.d_model, pdtype(cfg), device)


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> Transformer:
    """The model with parameters drawn from a ``torch.Generator`` seeded
    with ``seed`` on ``device`` (``None`` = the CUDA card; it raises
    ``RuntimeError`` with no card; ``"meta"`` allocates nothing)."""
    device = resolve_device(device)
    generator = None if device.type == "meta" else torch.Generator(device=device).manual_seed(seed)
    return Transformer(cfg, device=device, generator=generator)


def unit_stacks(cfg: ModelConfig) -> dict[str, list[str]]:
    """The parameters the reference stacks: ``units.{pos}.{name}`` → the
    ``state_dict`` names of that parameter in each repeat of unit position
    ``pos`` (layers ``pos``, ``pos + len(unit)``, ...), in order.  The
    tail's layers, the embedding and the final norm stand alone."""
    U = len(cfg.unit)
    return {f"units.{pos}.{name}": [f"layers.{i * U + pos}.{name}" for i in range(cfg.n_units)]
            for pos, kind in enumerate(cfg.unit)
            for name in Layer(kind, cfg, device="meta").state_dict()}


# ------------------------------------------------------------------ caches

def init_layer_cache(cfg: ModelConfig, kind: str, batch: int, seq_len: int, device=None):
    if kind in ("global", "local", "moe"):
        return attn_mod.init_cache(cfg, "local" if kind == "local" else "global", batch,
                                   seq_len, device)
    if kind == "ssm":
        return ssm_mod.init_ssm_state(cfg, batch, device)
    if kind == "rec":
        return rglru_mod.init_rglru_state(cfg, batch, device)
    return {}  # cross: kv recomputed from cross_embeds


def init_caches(cfg: ModelConfig, batch: int, seq_len: int, device=None) -> list:
    """One cache entry per layer, in ``cfg.layer_kinds()`` order, on
    ``device`` (``None`` = the CUDA card)."""
    device = resolve_device(device)
    return [init_layer_cache(cfg, kind, batch, seq_len, device) for kind in cfg.layer_kinds()]


def reset_caches(caches: list) -> list:
    """``caches`` set back to what :func:`init_caches` gives (ring positions
    −1, everything else 0), in place; returns them."""
    for cache in caches:
        for name, t in cache.items():
            t.fill_(-1 if name == "pos" else 0)
    return caches


# ------------------------------------------------------------------ layers

def apply_layer(
    p: Layer,
    x: torch.Tensor,
    kind: str,
    cfg: ModelConfig,
    positions: torch.Tensor,
    *,
    cross_embeds=None,
    cache=None,
    decode_pos=None,
):
    """Pre-norm residual block.  Returns (x, new_cache, aux)."""
    aux = {}
    if kind in ATTN_KINDS:
        a_kind = "global" if kind == "moe" else kind
        h, new_cache = attn_mod.attention_block(
            p.attn, rms_norm(x, p.attn_norm, cfg.norm_eps), cfg, a_kind, positions,
            cross_embeds=cross_embeds, cache=cache, decode_pos=decode_pos,
        )
        x = x + spmd.match_layout(h, x)
        hn = rms_norm(x, p.mlp_norm, cfg.norm_eps)
        if kind == "moe":
            h2, aux = moe_mod.apply_moe(p.moe, hn, cfg)
        else:
            h2 = apply_mlp(p.mlp, hn, cfg)
        return x + spmd.match_layout(h2, x), new_cache, aux
    if kind == "ssm":
        h, new_state = ssm_mod.ssm_block(p.ssm, rms_norm(x, p.norm, cfg.norm_eps), cfg,
                                         state=cache)
        return x + spmd.match_layout(h, x), new_state, aux
    if kind == "rec":
        h, new_state = rglru_mod.rglru_block(p.rec, rms_norm(x, p.norm, cfg.norm_eps), cfg,
                                             state=cache)
        x = x + spmd.match_layout(h, x)
        h2 = apply_mlp(p.mlp, rms_norm(x, p.mlp_norm, cfg.norm_eps), cfg)
        return x + spmd.match_layout(h2, x), new_state, aux
    raise ValueError(kind)


# ------------------------------------------------------------------ remat

def _save_dots(ctx, op, *args, **kwargs):
    """``dots_with_no_batch_dims_saveable``: keep the outputs of products
    with no batch dimension, recompute everything else."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg: ModelConfig):
    """``apply_layer`` under ``cfg.remat``'s checkpoint, or None for "none".
    The model draws no random numbers, so the checkpoint keeps no RNG state
    (reading it is refused while a CUDA graph is captured)."""
    if cfg.remat == "none":
        return None
    if cfg.remat == "full":
        return functools.partial(checkpoint, apply_layer, use_reentrant=False,
                                 preserve_rng_state=False)
    if cfg.remat == "dots":
        return functools.partial(
            checkpoint, apply_layer, use_reentrant=False, preserve_rng_state=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts, _save_dots))
    raise ValueError(f"remat must be none, full or dots, got {cfg.remat!r}")


# ----------------------------------------------------------------- forward

def _trunk(params: Transformer, tokens, cfg: ModelConfig, *, cross_embeds, caches,
           decode_pos, start_pos):
    """Every layer and the final norm → (x [B,T,d], aux, new_caches)."""
    T = tokens.shape[1]
    dev = tokens.device
    x = spmd.match_layout(embed_tokens(params.embed, tokens, cfg), tokens)
    if decode_pos is not None:
        positions = torch.zeros((T,), dtype=torch.int32, device=dev)  # unused in decode
    else:
        positions = torch.arange(T, dtype=torch.int32, device=dev) + start_pos
    lb = torch.zeros((), dtype=torch.float32, device=dev)
    new_caches = None if caches is None else []
    remat = _remat(cfg) if caches is None and torch.is_grad_enabled() else None
    for i, layer in enumerate(params.layers):
        run = remat if remat is not None and i < cfg.n_units * len(cfg.unit) else apply_layer
        x, nc, aux = run(
            layer, x, layer.kind, cfg, positions, cross_embeds=cross_embeds,
            cache=None if caches is None else caches[i], decode_pos=decode_pos,
        )
        if new_caches is not None:
            new_caches.append({} if nc is None else nc)
        if "load_balance_loss" in aux:
            lb = lb + aux["load_balance_loss"]
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return x, {"load_balance_loss": lb}, new_caches


def forward(
    params: Transformer,
    tokens: torch.Tensor,
    cfg: ModelConfig,
    *,
    cross_embeds=None,
    caches: list | None = None,
    decode_pos=None,
    start_pos: int = 0,
):
    """→ (logits [B,T,V], aux, new_caches_or_None)."""
    x, aux, new_caches = _trunk(params, tokens, cfg, cross_embeds=cross_embeds,
                                caches=caches, decode_pos=decode_pos, start_pos=start_pos)
    return lm_head(params.embed, x, cfg), aux, new_caches


# ------------------------------------------------------------------- loss

def loss_fn(params: Transformer, batch: dict, cfg: ModelConfig, lb_coef: float = 0.01):
    """Mean next-token cross-entropy over the labels that are not negative
    (log-softmax in float32), plus ``lb_coef`` × the MoE load-balance loss.
    → (loss, {"ce", "load_balance_loss"})."""
    logits, aux, _ = forward(params, batch["tokens"], cfg, cross_embeds=batch.get("cross_embeds"))
    labels = batch["labels"]
    valid = (labels >= 0).float()
    logp = spmd.log_softmax(logits.float())
    ll = spmd.pick(logp, labels.clamp(min=0).long())
    ce = -(ll * valid).sum() / torch.clamp(valid.sum(), min=1.0)
    loss = ce + lb_coef * aux["load_balance_loss"]
    return loss, {"ce": ce, **aux}


# ----------------------------------------------------------------- serving

@torch.no_grad()
def prefill(params: Transformer, tokens, cfg: ModelConfig, caches, *, cross_embeds=None):
    """Run the prompt through the model, filling ``caches`` (in place).
    Returns (last-token logits [B,V], new_caches).  Only the last position
    goes through ``lm_head``: the same logits as the reference's slice of
    the full [B,T,V] product, without materialising it."""
    x, _, new_caches = _trunk(params, tokens, cfg, cross_embeds=cross_embeds, caches=caches,
                              decode_pos=None, start_pos=0)
    return lm_head(params.embed, x[:, -1], cfg), new_caches


@torch.no_grad()
def decode_step(params: Transformer, tokens, position, cfg: ModelConfig, caches, *,
                cross_embeds=None):
    """One-token decode: tokens [B,1], ``position`` a 0-d int32 tensor on
    the tokens' device, as the reference passes it (an int is taken too).
    The step reads nothing back to the host, so it can be captured in a
    CUDA graph that takes the position from its buffer at every replay.
    Returns (logits [B,V], new_caches): the caches it was given, written in
    place."""
    if not isinstance(position, torch.Tensor):  # a fill on the device, not a host copy
        position = torch.full((), position, dtype=torch.int32, device=tokens.device)
    position = position.to(device=tokens.device, dtype=torch.int32)
    x, _, new_caches = _trunk(params, tokens, cfg, cross_embeds=cross_embeds, caches=caches,
                              decode_pos=position, start_pos=0)
    return lm_head(params.embed, x[:, -1], cfg), new_caches
