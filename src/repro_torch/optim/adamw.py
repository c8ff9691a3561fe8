"""AdamW with fp32 moments (decoupled weight decay).

The port's optimizers work on flat dicts of tensors keyed by the model's
``state_dict`` names: parameters, gradients and every moment alike.  The
moments and the step count are updated in place and returned in the new
state, so a step holds one copy of them (at 2.8 B parameters a second copy
is 22 GB), and a step captured in a CUDA graph updates the state it was
captured on.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable  # (grads, state, params) -> (updates, state)


def step_counter(device=None) -> torch.Tensor:
    """The optimizer's step count: an int32 scalar on the parameters'
    device, counted up in place by each update, so a step captured in a
    CUDA graph reads it (and the learning rate made from it) anew at every
    replay."""
    return torch.zeros((), dtype=torch.int32, device=device)


def count_step(state: dict) -> torch.Tensor:
    """``state["step"]`` plus one, written in place; returns it."""
    return state["step"].add_(1)


def adamw(
    lr: float | Callable = 1e-3,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
) -> Optimizer:
    """``lr`` a float or a schedule of the step (1 at the first update)."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params: dict) -> dict:
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
        return {"m": {k: zeros(p) for k, p in params.items()},
                "v": {k: zeros(p) for k, p in params.items()},
                "step": step_counter(_device(params))}

    @torch.no_grad()
    def update(grads: dict, state: dict, params: dict):
        step = count_step(state)
        t = step.float()
        lr_t = torch.as_tensor(lr_fn(step), dtype=torch.float32)
        bc1 = 1.0 - b1 ** t
        bc2 = 1.0 - b2 ** t
        updates = {}
        for k, g in grads.items():
            m, v, p = state["m"][k], state["v"][k], params[k]
            g32 = g.float()
            m.mul_(b1).add_((1 - b1) * g32)  # m_new = b1·m + (1 − b1)·g
            v.mul_(b2).add_((1 - b2) * g32 * g32)
            mhat = m / bc1
            vhat = v / bc2
            u = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.float()
            updates[k] = (-lr_t * u).to(p.dtype)
        return updates, {"m": state["m"], "v": state["v"], "step": step}

    return Optimizer(init=init, update=update)


def _device(params: dict):
    """The parameters' device (``None``, the default, for no parameters)."""
    return next(iter(params.values())).device if params else None


@torch.no_grad()
def apply_updates(params: dict, updates: dict) -> dict:
    """``p + u`` for every parameter, written into ``p`` in place (the
    model keeps its ``nn.Parameter``s, and no second copy of the weights is
    made); returns ``params``."""
    for k, p in params.items():
        p.add_(updates[k].to(p.dtype))
    return params
