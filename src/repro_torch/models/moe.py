"""Mixture-of-Experts FFN: top-k routing, shared experts, capacity dispatch.

The reference's capacity-slot formulation: route in float32, give each
(token, choice) a slot ``e·C + rank`` within its expert's capacity ``C``
(ranks by ``cumsum``; over-capacity choices are dropped), scatter-add the
tokens into an ``[E·C, d]`` buffer with ``index_add_``, run every expert as
one batched matmul, and gather back weighted by the router.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs.base import ModelConfig

from .layers import activation, cdtype, normal, pdtype


class SharedExperts(nn.Module):
    """The always-on experts, fused into one gated FFN of width
    ``d_ff · n_shared_experts``."""

    def __init__(self, cfg: ModelConfig, *, device=None, generator=None):
        super().__init__()
        d, ffs, dt = cfg.d_model, cfg.d_ff * cfg.n_shared_experts, pdtype(cfg)
        self.w_gate = normal((d, ffs), d ** -0.5, dt, device, generator)
        self.w_up = normal((d, ffs), d ** -0.5, dt, device, generator)
        self.w_down = normal((ffs, d), cfg.d_ff ** -0.5, dt, device, generator)


class MoE(nn.Module):
    """``router`` [d, E] (always float32), expert weights ``w_gate``/``w_up``
    [E, d, ff] and ``w_down`` [E, ff, d], and ``shared`` experts."""

    def __init__(self, cfg: ModelConfig, *, device=None, generator=None):
        super().__init__()
        d, ff, E, dt = cfg.d_model, cfg.d_ff, cfg.n_experts, pdtype(cfg)
        self.router = normal((d, E), d ** -0.5, torch.float32, device, generator)
        self.w_gate = normal((E, d, ff), d ** -0.5, dt, device, generator)
        self.w_up = normal((E, d, ff), d ** -0.5, dt, device, generator)
        self.w_down = normal((E, ff, d), ff ** -0.5, dt, device, generator)
        if cfg.n_shared_experts:
            self.shared = SharedExperts(cfg, device=device, generator=generator)


def capacity(n_tokens: int, cfg: ModelConfig) -> int:
    c = int(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)


def apply_moe(p: MoE, x: torch.Tensor, cfg: ModelConfig):
    """x: [B, T, d] → (out [B, T, d], aux_metrics dict).  On DTensors the
    router runs on the local tokens; the slot assignment, the capacity
    buffer and the combine are whole on every device, from gathered choices
    and tokens (the slots depend on every token's order); the experts split
    as their weights are (over experts or over d_ff), each device running
    its share on the whole buffer, as the reference's partitioner does."""
    dt = cdtype(cfg)
    B, T, d = x.shape
    N = B * T
    E, k = cfg.n_experts, cfg.top_k
    C = capacity(N, cfg)
    xf = x.reshape(N, d)

    # --- routing (fp32 for stable softmax/top-k)
    probs = torch.softmax(xf.float() @ p.router, dim=-1)  # [N, E]
    top_w, top_i = torch.topk(probs, k, dim=-1)  # [N, k]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    xs = xf
    if isinstance(x, DTensor):
        top_w, top_i, xs = top_w.full_tensor(), top_i.full_tensor(), xf.full_tensor()

    # --- capacity-slot assignment
    e_flat = top_i.reshape(-1)  # [N*k]
    w_flat = top_w.reshape(-1)
    # [N*k, E]; ``F.one_hot`` would read the largest index back to the host
    onehot = (e_flat[:, None] == torch.arange(E, device=e_flat.device)).long()
    pos_in_e = (torch.cumsum(onehot, dim=0) - 1).gather(1, e_flat[:, None])[:, 0]
    keep = pos_in_e < C
    slot = e_flat * C + torch.clamp(pos_in_e, max=C - 1)  # [N*k]

    tok_of_assign = torch.arange(N * k, device=xs.device) // k
    contrib = torch.where(keep[:, None], xs[tok_of_assign], 0).to(dt)
    buf = torch.zeros((E * C, d), dtype=dt, device=xs.device).index_add_(0, slot, contrib)
    buf = buf.reshape(E, C, d)
    if isinstance(x, DTensor):
        buf = DTensor.from_local(buf, x.device_mesh, [Replicate()] * x.device_mesh.ndim,
                                 run_check=False)

    # --- per-expert FFN (batched over the expert dim)
    act = activation(cfg)
    g = act(torch.bmm(buf, p.w_gate.to(dt)))
    u = torch.bmm(buf, p.w_up.to(dt))
    h = torch.bmm(g * u, p.w_down.to(dt))
    if isinstance(x, DTensor):
        h = h.full_tensor()
    h = h.reshape(E * C, d)

    # --- combine
    gathered = h[slot] * (w_flat * keep).to(dt)[:, None]  # [N*k, d]
    out = gathered.reshape(N, k, d).sum(dim=1)
    if isinstance(x, DTensor):
        mesh = x.device_mesh
        out = DTensor.from_local(out, mesh, [Replicate()] * mesh.ndim, run_check=False)
        out = out.redistribute(mesh, [pl if isinstance(pl, Shard) else Replicate()
                                      for pl in xf.placements])

    if cfg.n_shared_experts:
        s = p.shared
        gs = act(xf.to(dt) @ s.w_gate.to(dt))
        us = xf.to(dt) @ s.w_up.to(dt)
        out = out + (gs * us) @ s.w_down.to(dt)

    # --- aux: switch-style load-balance loss + drop fraction
    me = probs.mean(dim=0)  # mean router prob per expert
    ce = onehot.sum(dim=0).float() / (N * k)  # assignment frac
    aux = {
        "load_balance_loss": E * torch.sum(me * ce),
        "dropped_frac": 1.0 - keep.float().mean(),
    }
    return out.reshape(B, T, d), aux

