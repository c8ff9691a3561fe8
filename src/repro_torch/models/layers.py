"""Shared neural-net building blocks of the LM substrate, in PyTorch.

Every function keeps the reference's name, signature and arithmetic.  Where
the reference passes a parameter dict ``p``, the port passes an
``nn.Module`` that holds the same parameters under the same names, shapes
and layouts (``x @ w`` with ``w`` of shape ``[in, out]``), so a reference
parameter tree loads without transposes (``repro_torch.convert.lm_params``)
and the model moves, casts and builds on the ``meta`` device as one
module.

Every module takes ``device`` and ``generator`` (a ``torch.Generator`` on
that device): parameters are drawn from it, so a seed fixes them; on the
``meta`` device nothing is drawn or allocated.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig, torch_dtype


def cdtype(cfg: ModelConfig) -> torch.dtype:
    return torch_dtype(cfg.compute_dtype)


def pdtype(cfg: ModelConfig) -> torch.dtype:
    return torch_dtype(cfg.param_dtype)


def normal(shape, scale: float, dtype, device, generator) -> nn.Parameter:
    """A parameter drawn from N(0, scale²) in ``dtype`` (the reference's
    ``jax.random.normal(key, shape, dtype) * scale``)."""
    t = torch.empty(shape, dtype=dtype, device=device)
    if t.device.type != "meta":
        t.normal_(generator=generator).mul_(scale)
    return nn.Parameter(t)


def zeros(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device))


def write_state(state: dict, conv: torch.Tensor, h: torch.Tensor) -> dict:
    """A recurrent layer's new ``conv`` window and ``h`` copied into
    ``state``'s own tensors (a replayed CUDA graph reads next step what this
    step wrote there); returns ``state``."""
    state["conv"].copy_(conv)
    state["h"].copy_(h)
    return state


# ``jax.nn.gelu`` defaults to the tanh approximation, ``F.gelu`` to the
# exact erf: every GELU of the port is the tanh form
gelu = functools.partial(F.gelu, approximate="tanh")


def activation(cfg: ModelConfig):
    return F.silu if cfg.act == "silu" else gelu


# ---------------------------------------------------------------- norms

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in float32, scaled by ``1 + w``: ``w`` is stored as a
    zero-initialised delta around 1 (gemma convention; works for all)."""
    dt = x.dtype
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * (1.0 + w.float())).to(dt)


def init_rms_norm(d: int, dtype, device=None) -> nn.Parameter:
    return zeros((d,), dtype, device)


# ---------------------------------------------------------------- softcap

def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """gemma-2 logit soft-capping: cap·tanh(x/cap), in float32."""
    if not cap:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


# ---------------------------------------------------------------- rotary

def rope_frequencies(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., T, n, hd]; positions: broadcastable to [..., T], taken as
    float32.  Rotates the two halves of ``hd`` (not interleaved pairs)."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)  # [hd/2]
    angles = positions[..., None].to(torch.float32) * freqs  # [..., T, hd/2]
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- mlp

class MLP(nn.Module):
    """(Gated) feed-forward parameters: ``w_up``/``w_gate`` [d, ff],
    ``w_down`` [ff, d]."""

    def __init__(self, cfg: ModelConfig, d_ff: int | None = None, *, device=None,
                 generator=None):
        super().__init__()
        d, ff, dt = cfg.d_model, d_ff or cfg.d_ff, pdtype(cfg)
        self.w_up = normal((d, ff), d ** -0.5, dt, device, generator)
        self.w_down = normal((ff, d), ff ** -0.5, dt, device, generator)
        if cfg.mlp_gated:
            self.w_gate = normal((d, ff), d ** -0.5, dt, device, generator)


def apply_mlp(p: MLP, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dt = cdtype(cfg)
    act = activation(cfg)
    up = x @ p.w_up.to(dt)
    if cfg.mlp_gated:
        h = act(x @ p.w_gate.to(dt)) * up
    else:
        h = act(up)
    return h @ p.w_down.to(dt)


# ---------------------------------------------------------------- embedding

class Embed(nn.Module):
    """Token embedding ``tok`` [vocab, d] and, unless tied, the output
    projection ``head`` [d, vocab]."""

    def __init__(self, cfg: ModelConfig, *, device=None, generator=None):
        super().__init__()
        dt = pdtype(cfg)
        self.tok = normal((cfg.vocab, cfg.d_model), 0.02, dt, device, generator)
        if not cfg.tie_embeddings:
            self.head = normal((cfg.d_model, cfg.vocab), cfg.d_model ** -0.5, dt, device,
                               generator)


def embed_tokens(p: Embed, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dt = cdtype(cfg)
    x = F.embedding(tokens.long(), p.tok.to(dt))
    # gemma-style sqrt(d) scaling keeps rms ~1 under tied embeddings; the
    # factor is rounded to the compute dtype first, as in the reference (a
    # fill on the device: a copy from the host is refused in a CUDA graph)
    if cfg.tie_embeddings:
        x = x * torch.full((), cfg.d_model ** 0.5, dtype=dt, device=x.device)
    return x


def lm_head(p: Embed, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = x @ p.tok.to(cdtype(cfg)).T
    else:
        logits = x @ p.head.to(cdtype(cfg))
    return softcap(logits, cfg.final_softcap)
