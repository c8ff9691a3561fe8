"""Attention: GQA/MQA, local windows, cross-attention, softcap, KV caches.

Prefill uses the reference's double-blocked online-softmax ("flash")
attention, written as plain PyTorch loops over ``bq`` query blocks and
``bk`` key blocks with the same padding and position sentinel, so
activation memory is O(block²) rather than O(T·S).  Decode uses a single
cache-attention step against a ring cache.  Scores and the weighted sum
accumulate in float32 (the reference's ``preferred_element_type``): on the
card bf16 operands go to the tensor cores as they are, with float32 output
(``torch.bmm(..., out_dtype=torch.float32)``); elsewhere, and for float32
operands, they are widened exactly before each product (TF32 stays off).
The probabilities are rounded to the value dtype first, as the reference
rounds them.

Caches are dicts of tensors (``k``, ``v``, ``pos``; with ``opt_kv_quant``
also ``k_scale``, ``v_scale``).  Prefill and decode write into the cache
they are given and return it: the serving loop owns its caches and never
needs the old contents.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig

from .layers import apply_rope, cdtype, normal, pdtype, zeros
from .spmd import local_heads, merge_heads, split_heads, trips

NEG_INF = -1e30
POS_SENTINEL = 1 << 30  # key-position pad: fails every validity check


# --------------------------------------------------------------- parameters

def n_heads_eff(cfg: ModelConfig) -> int:
    """Query-head count after optional TP padding (exact numerics: the extra
    heads have zero wq rows and zero wo columns)."""
    return max(cfg.pad_heads_to, cfg.n_heads) if cfg.pad_heads_to else cfg.n_heads


class Attention(nn.Module):
    """``wq`` [d, H·hd], ``wk``/``wv`` [d, K·hd], ``wo`` [H·hd, d] and, with
    ``qkv_bias``, ``bq``/``bk``/``bv``."""

    def __init__(self, cfg: ModelConfig, *, device=None, generator=None):
        super().__init__()
        d, H, K, hd, dt = cfg.d_model, n_heads_eff(cfg), cfg.n_kv_heads, cfg.hd, pdtype(cfg)
        self.wq = normal((d, H * hd), d ** -0.5, dt, device, generator)
        self.wk = normal((d, K * hd), d ** -0.5, dt, device, generator)
        self.wv = normal((d, K * hd), d ** -0.5, dt, device, generator)
        self.wo = normal((H * hd, d), (H * hd) ** -0.5, dt, device, generator)
        if cfg.qkv_bias:
            self.bq = zeros((H * hd,), dt, device)
            self.bk = zeros((K * hd,), dt, device)
            self.bv = zeros((K * hd,), dt, device)


def _proj(p: Attention, x, cfg: ModelConfig, *, cross_from=None):
    """→ q [B,T,H,hd], k,v [B,S,K,hd]."""
    dt = cdtype(cfg)
    B, T, _ = x.shape
    H, K, hd = n_heads_eff(cfg), cfg.n_kv_heads, cfg.hd
    kv_src = x if cross_from is None else cross_from
    S = kv_src.shape[1]
    q = x @ p.wq.to(dt)
    k = kv_src @ p.wk.to(dt)
    v = kv_src @ p.wv.to(dt)
    if cfg.qkv_bias:
        q = q + p.bq.to(dt)
        k = k + p.bk.to(dt)
        v = v + p.bv.to(dt)
    return (split_heads(q, H, hd, uneven=True), split_heads(k, K, hd),
            split_heads(v, K, hd))


# ------------------------------------------------------ attention products

def _tensor_cores(*ts: torch.Tensor) -> bool:
    """The attention products take their bf16 operands as they are: on the
    card, where the tensor cores sum bf16 products in float32."""
    return all(t.is_cuda and t.dtype == torch.bfloat16 for t in ts)


class _Bf16Product(torch.autograd.Function):
    """[n, m, k] @ [n, k, p] of bf16 operands, summed and returned in
    float32: the reference's einsum with ``preferred_element_type=float32``.
    Each product of two bf16 values is exact in float32, so only the order
    of the float32 sums differs from the widened product.  The backward's
    products take a float32 gradient, so they run widened, and each
    operand's gradient is rounded to bf16 as the reference's transpose
    rounds it."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.bmm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.bmm(g, b.float().transpose(1, 2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = torch.bmm(a.float().transpose(1, 2), g).to(b.dtype)
        return ga, gb


def _block_product(a: torch.Tensor, b: torch.Tensor, tc: bool) -> torch.Tensor:
    """a [B,K,G,m,k] @ b [B,K,k,n] (the same b for the G query heads of a
    group) → float32 [B,K,G,m,n]: on the tensor cores as [B·K, G·m, k] @
    [B·K, k, n] when ``tc``, else widened."""
    if not tc:
        return a.float() @ b.float()[:, :, None]
    B, K, G, m, k = a.shape
    n = b.shape[-1]
    return _Bf16Product.apply(a.reshape(B * K, G * m, k), b.reshape(B * K, k, n)).reshape(
        B, K, G, m, n)


# --------------------------------------------------------- flash attention

def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    attn_softcap: float = 0.0,
    q_positions: torch.Tensor | None = None,
    kv_positions: torch.Tensor | None = None,
    bq: int = 512,
    bk: int = 512,
) -> torch.Tensor:
    """Double-blocked online-softmax attention.

    q [B,T,H,D]; k,v [B,S,K,D] with H = K·G (GQA).  Positions are absolute
    ([T]/[S] int32); local windows keep keys with qpos-window < kpos <= qpos.
    """
    B, T, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    G = H // K
    scale = D ** -0.5
    in_dtype, v_dtype, dev = q.dtype, v.dtype, q.device

    if q_positions is None:
        q_positions = torch.arange(T, dtype=torch.int32, device=dev)
    if kv_positions is None:
        kv_positions = torch.arange(S, dtype=torch.int32, device=dev)

    bq = min(bq, T)
    bk = min(bk, S)
    padT = (-T) % bq
    padS = (-S) % bk
    if padT:
        q = F.pad(q, (0, 0, 0, 0, 0, padT))
        q_positions = F.pad(q_positions, (0, padT))
    if padS:
        k = F.pad(k, (0, 0, 0, 0, 0, padS))
        v = F.pad(v, (0, 0, 0, 0, 0, padS))
        kv_positions = F.pad(kv_positions, (0, padS), value=POS_SENTINEL)
    Tp, Sp = T + padT, S + padS
    nq, nk = Tp // bq, Sp // bk

    tc = _tensor_cores(q, k, v)
    if not tc:
        q, k, v = q.float(), k.float(), v.float()
    # [nq, B, K, G, bq, D] / [nk, B, K, bk, D]
    qb = q.reshape(B, nq, bq, K, G, D).permute(1, 0, 3, 4, 2, 5)
    kb = k.reshape(B, nk, bk, K, D).permute(1, 0, 3, 2, 4)
    vb = v.reshape(B, nk, bk, K, D).permute(1, 0, 3, 2, 4)
    if tc:  # each block laid out once for the products' [B·K, rows, D] views
        qb, kb, vb = qb.contiguous(), kb.contiguous(), vb.contiguous()
    qpos_b = q_positions.reshape(nq, bq)
    kpos_b = kv_positions.reshape(nk, bk)

    blocks = []
    for i in trips(nq, q):
        qi, qpos = qb[i], qpos_b[i]  # [B,K,G,bq,D], [bq]
        o = torch.zeros((B, K, G, bq, D), dtype=torch.float32, device=dev)
        m = torch.full((B, K, G, bq), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, K, G, bq), dtype=torch.float32, device=dev)
        for j in trips(nk, q):
            ki, vi, kpos = kb[j], vb[j], kpos_b[j]  # [B,K,bk,D], [bk]
            s = _block_product(qi, ki.transpose(-1, -2), tc) * scale  # [B,K,G,bq,bk]
            if attn_softcap:
                s = attn_softcap * torch.tanh(s / attn_softcap)
            valid = kpos[None, :] < POS_SENTINEL // 2
            if causal:
                valid = valid & (kpos[None, :] <= qpos[:, None])
            if window:
                valid = valid & (kpos[None, :] > qpos[:, None] - window)
            s = torch.where(valid, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            pmat = torch.exp(s - m_new[..., None])
            l = l * alpha + pmat.sum(dim=-1)
            pv = _block_product(pmat.to(v_dtype), vi, tc)
            o = o * alpha[..., None] + pv
            m = m_new
        o = o / torch.clamp(l, min=1e-20)[..., None]
        blocks.append(o.to(in_dtype))

    # [nq, B, K, G, bq, D] → [B, T, H, D]
    blocks += blocks[-1:] * (nq - len(blocks))  # counted on meta tensors: one trip
    out = torch.stack(blocks).permute(1, 0, 4, 2, 3, 5).reshape(B, Tp, H, D)
    return out[:, :T]


# ----------------------------------------------------------------- decode

def decode_attention(
    q: torch.Tensor,  # [B, 1, H, D]
    k_cache: torch.Tensor,  # [B, S, K, D]
    v_cache: torch.Tensor,
    kv_positions: torch.Tensor,  # [S] absolute positions (-1 = empty)
    position,  # int (or scalar tensor): current decode position
    *,
    window: int = 0,
    attn_softcap: float = 0.0,
) -> torch.Tensor:
    B, _, H, D = q.shape
    K = k_cache.shape[2]
    G = H // K
    scale = D ** -0.5
    S = k_cache.shape[1]
    tc = _tensor_cores(q, k_cache, v_cache)
    if tc:  # [B·K, G, D] @ [B·K, D, S] on the tensor cores
        s = _Bf16Product.apply(q.reshape(B * K, G, D),
                               k_cache.permute(0, 2, 3, 1).reshape(B * K, D, S))
        s = s.reshape(B, K, G, S) * scale
    else:
        qh = q.reshape(B, K, G, D).float()
        s = (qh @ k_cache.float().permute(0, 2, 3, 1)) * scale  # [B,K,G,S]
    if attn_softcap:
        s = attn_softcap * torch.tanh(s / attn_softcap)
    valid = (kv_positions >= 0) & (kv_positions <= position)
    if window:
        valid = valid & (kv_positions > position - window)
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    if tc:
        o = _Bf16Product.apply(p.to(v_cache.dtype).reshape(B * K, G, S),
                               v_cache.permute(0, 2, 1, 3).reshape(B * K, S, D))
    else:
        o = p.to(v_cache.dtype).float() @ v_cache.float().permute(0, 2, 1, 3)  # [B,K,G,D]
    return o.reshape(B, 1, H, D).to(q.dtype)


# ------------------------------------------------------------ full blocks

def attention_block(
    p: Attention,
    x: torch.Tensor,
    cfg: ModelConfig,
    kind: str,  # global | local | cross
    positions: torch.Tensor,
    *,
    cross_embeds: torch.Tensor | None = None,
    cache: dict | None = None,
    decode_pos: torch.Tensor | None = None,
):
    """Returns (out, cache_entry_or_None).

    Train/prefill (``decode_pos is None``): flash path; given a ``cache``
    (a self-attention layer's ring from :func:`init_cache`) the prompt's
    k/v are written into it.  Decode: ``x`` is [B, 1, d], ``cache`` holds
    {k, v, pos} and ``decode_pos`` is the new token's position, a 0-d int32
    tensor on the cache's device.  A cross
    layer keeps no cache: its k/v come from ``cross_embeds`` every step.
    """
    dt = cdtype(cfg)
    T = x.shape[1]
    window = cfg.window if kind == "local" else 0

    if cache is not None and decode_pos is not None and kind != "cross":
        # ---- one-token decode against the ring cache; the position is a
        # 0-d int32 tensor, and nothing here reads it back to the host
        q, k_new, v_new, ring, expand, wrap = local_heads(*_proj(p, x, cfg), cache)
        pos = decode_pos.reshape(1, 1).expand(q.shape[0], 1)
        q = apply_rope(q, pos, cfg.rope_theta)
        k_new = apply_rope(k_new, pos, cfg.rope_theta)
        slot = (decode_pos % ring["k"].shape[1]).reshape(1).long()
        if cfg.opt_kv_quant:
            # int8 KV: symmetric per-(token, head) scales, dequantised in
            # the compute dtype before the attention products
            kq, ksc = _quant_kv(k_new)
            vq, vsc = _quant_kv(v_new)
            for name, new in (("k", kq), ("v", vq), ("k_scale", ksc), ("v_scale", vsc)):
                ring[name].index_copy_(1, slot, new)
            k_att = ring["k"].to(dt) * ring["k_scale"][..., None].to(dt)
            v_att = ring["v"].to(dt) * ring["v_scale"][..., None].to(dt)
        else:
            ring["k"].index_copy_(1, slot, k_new)
            ring["v"].index_copy_(1, slot, v_new)
            k_att, v_att = ring["k"], ring["v"]
        ring["pos"].index_copy_(0, slot, decode_pos.reshape(1))
        o = decode_attention(q, expand(k_att), expand(v_att), ring["pos"], decode_pos,
                             window=window, attn_softcap=cfg.attn_softcap)
        return merge_heads(wrap(o)) @ p.wo.to(dt), cache

    if kind == "cross":
        assert cross_embeds is not None
        q, k, v, _, expand, wrap = local_heads(
            *_proj(p, x, cfg, cross_from=cross_embeds.to(dt)), None)
        o = flash_attention(
            q, expand(k), expand(v), causal=False, attn_softcap=cfg.attn_softcap,
            q_positions=positions,
            kv_positions=torch.arange(k.shape[1], dtype=torch.int32, device=q.device),
            bq=cfg.attn_bq, bk=cfg.attn_bk,
        )
        return merge_heads(wrap(o)) @ p.wo.to(dt), None

    # ---- training / prefill self-attention
    q, k, v, ring, expand, wrap = local_heads(*_proj(p, x, cfg), cache)
    B = q.shape[0]
    q = apply_rope(q, positions[None, :].expand(B, T), cfg.rope_theta)
    k = apply_rope(k, positions[None, :].expand(B, T), cfg.rope_theta)
    k_att, v_att = expand(k), expand(v)
    if cfg.opt_attn_layout and q.shape[2] != k_att.shape[2]:
        # head-aligned layout: KV repeated to the query-head count
        g = q.shape[2] // k_att.shape[2]
        k_att = k_att.repeat_interleave(g, dim=2)
        v_att = v_att.repeat_interleave(g, dim=2)
    o = flash_attention(
        q, k_att, v_att, causal=True, window=window, attn_softcap=cfg.attn_softcap,
        q_positions=positions, kv_positions=positions, bq=cfg.attn_bq, bk=cfg.attn_bk,
    )
    out = merge_heads(wrap(o)) @ p.wo.to(dt)

    if cache is None:
        return out, None
    # prefill: write the prompt's last S_c tokens into the ring
    S_c = ring["k"].shape[1]
    if T >= S_c:
        k_w, v_w, pos_w = k[:, -S_c:], v[:, -S_c:], positions[-S_c:]
    else:
        k_w, v_w, pos_w = k, v, positions
    slots = (pos_w % S_c).long()
    ring["pos"][slots] = pos_w.to(torch.int32)
    if cfg.opt_kv_quant:
        kq, ksc = _quant_kv(k_w)
        vq, vsc = _quant_kv(v_w)
        ring["k"][:, slots] = kq
        ring["v"][:, slots] = vq
        ring["k_scale"][:, slots] = ksc
        ring["v_scale"][:, slots] = vsc
    else:
        ring["k"][:, slots] = k_w
        ring["v"][:, slots] = v_w
    return out, cache


def _quant_kv(x: torch.Tensor):
    """x [B, T, K, hd] → (int8 [B,T,K,hd], scales f32 [B,T,K]); rounds half
    to even, as ``jnp.round`` does."""
    x32 = x.float()
    scale = torch.clamp(x32.abs().amax(dim=-1), min=1e-6) / 127.0
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def init_cache(cfg: ModelConfig, kind: str, batch: int, seq_len: int, device=None) -> dict:
    """Zeroed ring cache for one attention layer: ``min(seq_len, window)``
    slots for a local layer, ``seq_len`` otherwise; ``pos`` −1 marks an
    empty slot."""
    S_c = min(seq_len, cfg.window) if kind == "local" else seq_len
    K, hd = cfg.n_kv_heads, cfg.hd
    pos = torch.full((S_c,), -1, dtype=torch.int32, device=device)
    if cfg.opt_kv_quant:
        return {
            "k": torch.zeros((batch, S_c, K, hd), dtype=torch.int8, device=device),
            "v": torch.zeros((batch, S_c, K, hd), dtype=torch.int8, device=device),
            "k_scale": torch.zeros((batch, S_c, K), dtype=torch.float32, device=device),
            "v_scale": torch.zeros((batch, S_c, K), dtype=torch.float32, device=device),
            "pos": pos,
        }
    dt = cdtype(cfg)
    return {
        "k": torch.zeros((batch, S_c, K, hd), dtype=dt, device=device),
        "v": torch.zeros((batch, S_c, K, hd), dtype=dt, device=device),
        "pos": pos,
    }
