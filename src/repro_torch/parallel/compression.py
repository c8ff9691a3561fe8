"""Gradient compression: int8 error-feedback all-reduce (distributed-opt trick).

Structure = quantized reduce-scatter (all-to-all of int8 segments) → local
dequant-sum → requantize → int8 all-gather.  Per-device wire bytes ≈ 2N·1B
versus a ring fp32 all-reduce's ≈ 8N·1B → ~4× link saving on the gradient
exchange.  int8 rounding of the *contribution* is absorbed by per-device
error feedback (the residual is carried to the next step, so the accumulated
update is unbiased); the post-reduction requantization error is shared and
bounded by 1/127 of the segment max.

Plain PyTorch over a ``torch.distributed`` group, the same arithmetic in the
same order as the reference.  Every rank of ``group`` calls it with its own
gradient; the data axis of a mesh is ``mesh.get_group("data")``:

    g_sync, err = compressed_psum_mean(g_local, err, group=mesh.get_group("data"))
"""

from __future__ import annotations

import torch
import torch.distributed as dist

CHUNK = 256  # per-scale quantization group


def _exact(divisor: float, like: torch.Tensor) -> torch.Tensor:
    """A divisor as a float32 tensor on ``like``'s device: CUDA divides by a
    Python number as a product with its reciprocal, which may round
    otherwise than the division the reference (and the CPU) takes."""
    return torch.tensor(float(divisor), dtype=torch.float32, device=like.device)


def _quantize_rows(x: torch.Tensor):
    """x: [R, M] fp32, M % CHUNK == 0 → (int8 [R, M], scales [R, M/CHUNK]).
    Rounds half to even, as ``jnp.round``."""
    R, M = x.shape
    xp = x.reshape(R, M // CHUNK, CHUNK)
    scale = torch.clamp(xp.abs().amax(dim=-1), min=1e-12) / _exact(127.0, x)
    q = torch.clamp(torch.round(xp / scale[..., None]), -127, 127).to(torch.int8)
    return q.reshape(R, M), scale.float()


def _dequantize_rows(q: torch.Tensor, scale: torch.Tensor):
    R, M = q.shape
    x = q.float().reshape(R, M // CHUNK, CHUNK) * scale[..., None]
    return x.reshape(R, M)


def compressed_psum_mean(g: torch.Tensor, err: torch.Tensor, group=None):
    """Error-feedback int8 mean-reduce over ``group`` (default: the
    default process group); every rank calls it.

    Returns (mean gradient, new local error residual), both float32 in
    ``g``'s shape."""
    D = dist.get_world_size(group)
    n = g.numel()
    flat = g.reshape(-1).float() + err.reshape(-1)
    seg = -(-n // (D * CHUNK)) * CHUNK  # segment length, CHUNK-aligned
    pad = D * seg - n
    flat_p = torch.nn.functional.pad(flat, (0, pad)).reshape(D, seg)

    # quantize my contribution, remember what was actually sent (EF residual)
    q, s = _quantize_rows(flat_p)
    new_err = (flat_p - _dequantize_rows(q, s)).reshape(-1)[:n]

    # reduce-scatter: rank i ends up owning segment i from every peer
    q_x, s_x = torch.empty_like(q), torch.empty_like(s)
    dist.all_to_all_single(q_x, q, group=group)
    dist.all_to_all_single(s_x, s, group=group)
    own = _dequantize_rows(q_x, s_x).sum(dim=0) / _exact(D, g)  # [seg]

    # requantize the reduced segment and all-gather it back
    q2, s2 = _quantize_rows(own[None, :])
    q_all = torch.empty(D * seg, dtype=torch.int8, device=g.device)
    s_all = torch.empty(D * (seg // CHUNK), dtype=torch.float32, device=g.device)
    dist.all_gather_into_tensor(q_all, q2[0], group=group)
    dist.all_gather_into_tensor(s_all, s2[0], group=group)
    mean = _dequantize_rows(q_all.reshape(D, seg), s_all.reshape(D, -1)).reshape(-1)[:n]
    return mean.reshape(g.shape), new_err.reshape(g.shape)


def uncompressed_psum_mean(g: torch.Tensor, group=None):
    """The float32 mean of ``g`` over ``group`` by one all-reduce."""
    out = g.float().clone()
    dist.all_reduce(out, group=group)
    return out / _exact(dist.get_world_size(group), g)
