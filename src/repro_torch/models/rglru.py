"""RG-LRU recurrent block (Griffin / RecurrentGemma [arXiv:2402.19427]).

Gated linear recurrence h_t = a_t ⊙ h_{t-1} + √(1-a_t²) ⊙ (i_t ⊙ x_t) with
a_t = exp(-c·softplus(Λ)·r_t).  Prefill runs the recurrence as a log-depth
(Hillis–Steele) scan over T in float32 — the reference's
``associative_scan`` composes the same pairs in another order, so the two
agree to float32 rounding (within 1e-5 relative and absolute in
``tests/test_torch_lm.py``), not bit for bit; decode carries a [B, w]
state, O(1) per token.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig

from .layers import cdtype, gelu, normal, pdtype, write_state, zeros
from .spmd import depthwise_conv1d, pad

_C = 8.0  # Griffin's recurrence-gate sharpness constant


class RGLRU(nn.Module):
    """Branch projections ``w_x``/``w_y`` [d, w], conv ``conv_w`` [W, w] and
    ``conv_b``, float32 gates ``w_r``/``w_i`` [w, w] and ``lam`` [w], and
    ``w_out`` [w, d]."""

    def __init__(self, cfg: ModelConfig, *, device=None, generator=None):
        super().__init__()
        d, w, W, dt = cfg.d_model, cfg.lru_dim, cfg.conv_width, pdtype(cfg)
        self.w_x = normal((d, w), d ** -0.5, dt, device, generator)
        self.w_y = normal((d, w), d ** -0.5, dt, device, generator)
        self.conv_w = normal((W, w), 0.1, dt, device, generator)
        self.conv_b = zeros((w,), dt, device)
        self.w_r = normal((w, w), w ** -0.5, torch.float32, device, generator)
        self.w_i = normal((w, w), w ** -0.5, torch.float32, device, generator)
        # Λ init so that a^c ∈ (0.9, 0.999) at r=1 (Griffin appendix)
        a = torch.linspace(0.9, 0.999, w, dtype=torch.float32, device=device)
        self.lam = nn.Parameter(torch.log(torch.expm1(-torch.log(a) / _C)))
        self.w_out = normal((w, d), w ** -0.5, dt, device, generator)


def _gates(p: RGLRU, xc):
    """xc [..., w] fp32 → (a, gated_input_scale)."""
    r = torch.sigmoid(xc @ p.w_r)
    i = torch.sigmoid(xc @ p.w_i)
    log_a = -_C * F.softplus(p.lam) * r  # [..., w], <= 0
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
    return a, beta * i


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t·h_{t-1} + b_t over dim 1 with h_0 = 0, in ⌈log2 T⌉ steps:
    each step composes every element with the one ``off`` before it."""
    T = a.shape[1]
    for k in range(math.ceil(math.log2(T)) if T > 1 else 0):
        off = 1 << k
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]], dim=1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
    return b


def rglru_block(p: RGLRU, x: torch.Tensor, cfg: ModelConfig, state: dict | None = None):
    """Returns (y [B,T,d], new_state_or_None).

    state (decode): {"conv": [B, W-1, w], "h": [B, w]}.  Given a ``state``,
    the new one is written into its tensors, and it is returned."""
    dt_ = cdtype(cfg)
    B, T, _ = x.shape
    w, W = cfg.lru_dim, cfg.conv_width

    xb = x @ p.w_x.to(dt_)  # recurrent branch
    yb = gelu(x @ p.w_y.to(dt_))  # gate branch

    if state is not None and T == 1:
        window = torch.cat([state["conv"], xb], dim=1)  # [B, W, w]
        xc = (window * p.conv_w.to(dt_)[None]).sum(1) + p.conv_b.to(dt_)
        xc = xc.float()
        a, scale = _gates(p, xc)
        h = a * state["h"] + scale * xc
        out = (h.to(dt_)[:, None] * yb) @ p.w_out.to(dt_)
        return out, write_state(state, window[:, 1:], h)

    # prefill / train: causal depthwise conv then the scan over T
    xp = pad(xb, (0, 0, W - 1, 0)) if state is None else torch.cat([state["conv"], xb], dim=1)
    xc = depthwise_conv1d(xp.transpose(1, 2), p.conv_w.to(dt_).T[:, None, :], groups=w)
    xc = xc.transpose(1, 2) + p.conv_b.to(dt_)
    xc32 = xc.float()
    a, scale = _gates(p, xc32)
    b = scale * xc32
    if state is not None:
        # fold the carried h into the first step: h_1 = a_1 h_0 + b_1
        b[:, 0] += a[:, 0] * state["h"]
    h = linear_scan(a, b)
    out = (h.to(dt_) * yb) @ p.w_out.to(dt_)

    new_state = None
    if state is not None:
        conv_tail = xb[:, -(W - 1):] if T >= W - 1 else torch.cat(
            [state["conv"][:, T:], xb], dim=1)
        new_state = write_state(state, conv_tail, h[:, -1])
    return out, new_state


def init_rglru_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, cfg.lru_dim), dtype=cdtype(cfg),
                            device=device),
        "h": torch.zeros((batch, cfg.lru_dim), dtype=torch.float32, device=device),
    }
