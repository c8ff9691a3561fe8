"""Adafactor (factored second moments): about 4 bytes of optimizer state a
parameter against AdamW's 8, the memory plan for the largest models.

Every tensor of two or more dimensions keeps a row and a column second
moment (``vr``, ``vc``) over its last two axes; vectors keep a full ``v``.
The reference stacks each unit position's repeats into one tensor, and so
factors a stack of norm vectors over the repeats and takes the update's RMS
clip over the whole stack.  ``stacks`` gives the port the same algorithm:
each entry names parameters that are updated as one tensor stacked on a
new first axis, with their state kept under the entry's key
(``models.transformer.unit_stacks(cfg)`` names the reference's stacks).
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate

from .adamw import Optimizer, _device, count_step, step_counter


def adafactor(
    lr: float = 1e-2,
    decay: float = 0.8,
    eps: float = 1e-30,
    clip_threshold: float = 1.0,
    weight_decay: float = 0.0,
    stacks: dict[str, list[str]] | None = None,
) -> Optimizer:
    """``stacks``: state key → the parameter names stacked under it, in
    order; every other parameter is its own tensor, keyed by its name."""
    stacks = dict(stacks or {})
    stacked = {name: key for key, names in stacks.items() for name in names}

    def _factored(shape) -> bool:
        return len(shape) >= 2

    def _groups(names) -> dict[str, list[str]]:
        """State key → its parameter names, keys in the order their first
        parameter comes in ``names``."""
        groups: dict[str, list[str]] = {}
        for name in names:
            key = stacked.get(name, name)
            if key not in groups:
                groups[key] = stacks.get(key, [name])
        return groups

    def _gather(tensors: dict, key: str, names: list[str]) -> torch.Tensor:
        return torch.stack([tensors[n] for n in names]) if key in stacks else tensors[key]

    def init(params: dict) -> dict:
        def one(names):
            p = params[names[0]]
            shape = (len(names), *p.shape) if names[0] in stacked else tuple(p.shape)
            f32 = {"dtype": torch.float32, "device": p.device}
            if _factored(shape):
                return {"vr": torch.zeros(shape[:-1], **f32),
                        "vc": torch.zeros(shape[:-2] + shape[-1:], **f32)}
            return {"v": torch.zeros(shape, **f32)}

        return {"s": {key: one(names) for key, names in _groups(params).items()},
                "step": step_counter(_device(params))}

    @torch.no_grad()
    def update(grads: dict, state: dict, params: dict):
        step = count_step(state)
        t = step.float()
        beta = 1.0 - t ** (-decay)
        updates = {}
        for key, names in _groups(grads).items():
            s = state["s"][key]
            g32 = _gather(grads, key, names).float()
            g2 = g32 * g32 + eps
            if _factored(g32.shape):  # the moments written in place
                s["vr"].copy_(beta * s["vr"] + (1 - beta) * g2.mean(dim=-1))
                s["vc"].copy_(beta * s["vc"] + (1 - beta) * g2.mean(dim=-2))
                vr, vc = s["vr"], s["vc"]
                denom = vr[..., None] * vc[..., None, :] / torch.clamp(
                    vr.mean(dim=-1, keepdim=True)[..., None], min=eps)
                u = g32 * torch.rsqrt(denom + eps)
            else:
                s["v"].copy_(beta * s["v"] + (1 - beta) * g2)
                u = g32 * torch.rsqrt(s["v"] + eps)
            rms_u = torch.sqrt(torch.mean(u * u) + eps)
            u = u / torch.clamp(rms_u / clip_threshold, min=1.0)
            if weight_decay:
                u = u + weight_decay * _gather(params, key, names).float()
            upd = (-lr * u).to(params[names[0]].dtype)
            if isinstance(upd, DTensor):  # a stack is split only as its parameters are
                upd = upd.redistribute(upd.device_mesh, [Replicate() if pl.is_partial() else pl
                                                         for pl in g32.placements])
            updates.update(zip(names, upd.unbind(0)) if key in stacks else [(key, upd)])
        return updates, {"s": state["s"], "step": step}

    return Optimizer(init=init, update=update)
