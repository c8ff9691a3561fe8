"""Global-norm gradient clipping over a dict of tensors."""

from __future__ import annotations

import torch


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of every element's square, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree.values()))


@torch.no_grad()
def clip_by_global_norm(tree: dict, max_norm: float):
    """(every tensor scaled by min(1, max_norm / norm), norm)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return {k: (g.float() * scale).to(g.dtype) for k, g in tree.items()}, norm
