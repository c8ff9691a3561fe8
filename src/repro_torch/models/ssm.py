"""Mamba-2 SSD (state-space duality) block [arXiv:2405.21060].

The reference's chunked algorithm as a loop over time chunks: within a
chunk the quadratic "attention-like" term is a batched matmul; across
chunks a [nh, hp, ds] float32 state is carried — O(1) decode memory,
linear-time prefill.  Single B/C group (mamba-2 default), gated RMSNorm
before the output projection.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig

from .layers import cdtype, normal, pdtype, rms_norm, write_state, zeros
from .spmd import depthwise_conv1d, scan_heads, trips
from .spmd import pad as spmd_pad


class SSM(nn.Module):
    """Fused in-projection ``w_in`` (z | x | B | C | dt), depthwise causal
    conv ``conv_w`` [W, C] and ``conv_b``, ``A_log``/``D``/``dt_bias``
    (float32), gated-norm ``norm_w`` and ``w_out``."""

    def __init__(self, cfg: ModelConfig, *, device=None, generator=None):
        super().__init__()
        d, dt = cfg.d_model, pdtype(cfg)
        di, ds, nh, w = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads, cfg.conv_width
        conv_ch = di + 2 * ds
        self.w_in = normal((d, 2 * di + 2 * ds + nh), d ** -0.5, dt, device, generator)
        self.conv_w = normal((w, conv_ch), 0.1, dt, device, generator)
        self.conv_b = zeros((conv_ch,), dt, device)
        self.A_log = nn.Parameter(torch.log(torch.linspace(
            1.0, 16.0, nh, dtype=torch.float32, device=device)))
        self.D = nn.Parameter(torch.ones((nh,), dtype=torch.float32, device=device))
        self.dt_bias = zeros((nh,), torch.float32, device)
        self.norm_w = zeros((di,), dt, device)
        self.w_out = normal((di, d), di ** -0.5, dt, device, generator)


def _split_in(h, cfg: ModelConfig):
    di, ds = cfg.d_inner, cfg.ssm_state
    z = h[..., :di]
    xin = h[..., di : 2 * di]
    Bc = h[..., 2 * di : 2 * di + ds]
    Cc = h[..., 2 * di + ds : 2 * di + 2 * ds]
    dt = h[..., 2 * di + 2 * ds :]
    return z, xin, Bc, Cc, dt


def _causal_conv(x, w, b):
    """Depthwise causal conv: x [B,T,C], w [W,C] — a grouped ``F.conv1d``
    (cross-correlation, as XLA's convolution) over a left-padded input."""
    W, C = w.shape
    xp = spmd_pad(x.transpose(1, 2), (W - 1, 0))  # [B, C, T+W-1]
    out = depthwise_conv1d(xp, w.T[:, None, :], groups=C)  # weight [C, 1, W]
    return out.transpose(1, 2) + b


def ssm_block(p: SSM, x: torch.Tensor, cfg: ModelConfig, state: dict | None = None):
    """Returns (y [B,T,d], new_state_or_None).

    state (decode): {"conv": [B, W-1, conv_ch], "h": [B, nh, hp, ds]} — pass
    T=1 inputs for one-token decode; T>1 runs the chunked prefill/train path.
    Given a ``state``, both write the new one into its tensors and return
    it."""
    dt_ = cdtype(cfg)
    B, T, _ = x.shape
    di, ds, nh, hp = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_headdim
    W = cfg.conv_width

    hin = x @ p.w_in.to(dt_)
    z, xin, Bc, Cc, dtp = _split_in(hin, cfg)
    conv_in = torch.cat([xin, Bc, Cc], dim=-1)
    A = -torch.exp(p.A_log)  # [nh]

    if state is not None and T == 1:
        # ---- one-token decode
        window = torch.cat([state["conv"], conv_in], dim=1)  # [B, W, C]
        conv_out = (window * p.conv_w.to(dt_)[None]).sum(1, keepdim=True)
        conv_out = F.silu(conv_out + p.conv_b.to(dt_))
        xin_c, Bc_c, Cc_c = (
            conv_out[..., :di], conv_out[..., di : di + ds], conv_out[..., di + ds :]
        )
        dt = F.softplus(dtp[:, 0].float() + p.dt_bias)  # [B, nh]
        dA = torch.exp(dt * A)  # [B, nh]
        xh = xin_c.reshape(B, nh, hp).float()
        Bf = Bc_c[:, 0].float()  # [B, ds]
        Cf = Cc_c[:, 0].float()
        h_new = dA[..., None, None] * state["h"] + torch.einsum("bh,bs,bhp->bhps", dt, Bf, xh)
        y = torch.einsum("bs,bhps->bhp", Cf, h_new) + p.D[None, :, None] * xh
        y = y.reshape(B, 1, di).to(dt_)
        y = rms_norm(y * F.silu(z), p.norm_w, cfg.norm_eps)
        return y @ p.w_out.to(dt_), write_state(state, window[:, 1:], h_new)

    # ---- chunked prefill / train
    conv_out = F.silu(_causal_conv(conv_in, p.conv_w.to(dt_), p.conv_b.to(dt_)))
    xin_c = conv_out[..., :di]
    Bc_c = conv_out[..., di : di + ds].float()
    Cc_c = conv_out[..., di + ds :].float()
    dt = F.softplus(dtp.float() + p.dt_bias)  # [B,T,nh]
    logdA = dt * A  # [B,T,nh], <= 0

    h = state["h"].float() if state is not None else torch.zeros(
        (B, nh, hp, ds), dtype=torch.float32, device=x.device)
    xh = xin_c.reshape(B, T, nh, hp).float()
    y, h = scan_heads(functools.partial(_ssd_scan, Q=min(cfg.ssm_chunk, T)),
                      xh, Bc_c, Cc_c, dt, logdA, h)
    y = y + p.D[None, None, :, None] * xh
    y = y.reshape(B, T, di).to(dt_)
    y = rms_norm(y * F.silu(z), p.norm_w, cfg.norm_eps)
    out = y @ p.w_out.to(dt_)

    new_state = None
    if state is not None:
        conv_tail = conv_in[:, -(W - 1):] if T >= W - 1 else torch.cat(
            [state["conv"][:, T:], conv_in], dim=1)
        new_state = write_state(state, conv_tail, h)
    return out, new_state


def _ssd_scan(xh, Bc, Cc, dt, logdA, h, *, Q: int):
    """The chunked SSD scan: xh [B,T,nh,hp], Bc/Cc [B,T,ds], dt/logdA
    [B,T,nh] (float32), h [B,nh,hp,ds] carried in → (y [B,T,nh,hp], h)."""
    B, T, nh, hp = xh.shape
    ds = Bc.shape[-1]
    pad = (-T) % Q
    if pad:
        xh, Bc, Cc, dt, logdA = (F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))
                                 for t in (xh, Bc, Cc, dt, logdA))
    Tp = T + pad
    nc = Tp // Q
    xh = xh.reshape(B, nc, Q, nh, hp)
    Bb = Bc.reshape(B, nc, Q, ds)
    Cb = Cc.reshape(B, nc, Q, ds)
    dtb = dt.reshape(B, nc, Q, nh)
    lab = logdA.reshape(B, nc, Q, nh)

    # loop over chunks; carry h [B, nh, hp, ds]
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xh.device))
    ys = []
    for c in trips(nc, xh):
        xc, Bcc, Ccc, dtc, lac = xh[:, c], Bb[:, c], Cb[:, c], dtb[:, c], lab[:, c]
        la = torch.cumsum(lac, dim=1)  # inclusive cumulative log-decay [B,Q,nh]
        # inter-chunk: y_inter[i] = exp(la_i) * C_i · h
        y_inter = torch.einsum("bqs,bhps->bqhp", Ccc, h) * torch.exp(la)[..., None]
        # intra-chunk: scores[i,j] = (C_i·B_j) exp(la_i - la_j) dt_j  (j<=i)
        cb = torch.einsum("bqs,bps->bqp", Ccc, Bcc)  # [B,Q,Q]
        # mask *inside* the exp: la_i - la_j > 0 on the upper triangle would
        # overflow to inf (inf·0 = NaN after tri-masking)
        ldiff = torch.where(tri[None, :, :, None], la[:, :, None, :] - la[:, None, :, :],
                            -torch.inf)
        scores = cb[..., None] * torch.exp(ldiff) * dtc[:, None, :, :]
        y_intra = torch.einsum("bqph,bphx->bqhx", scores, xc)
        # state to next chunk: h' = exp(la_last) h + Σ_j exp(la_last-la_j) dt_j B_j⊗x_j
        la_last = la[:, -1:, :]  # [B,1,nh]
        w = torch.exp(la_last - la) * dtc  # [B,Q,nh]
        h = torch.exp(la_last[:, 0])[:, :, None, None] * h + torch.einsum(
            "bqh,bqs,bqhp->bhps", w, Bcc, xc)
        ys.append(y_inter + y_intra)

    ys += ys[-1:] * (nc - len(ys))  # counted on meta tensors: one trip
    return torch.stack(ys, dim=1).reshape(B, Tp, nh, hp)[:, :T], h


def init_ssm_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, cfg.d_inner + 2 * cfg.ssm_state),
                            dtype=cdtype(cfg), device=device),
        "h": torch.zeros((batch, cfg.n_ssm_heads, cfg.ssm_headdim, cfg.ssm_state),
                         dtype=torch.float32, device=device),
    }
