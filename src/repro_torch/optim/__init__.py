"""Optimizers written out in PyTorch ops, on dicts of tensors keyed by the
model's ``state_dict`` names."""

from .adafactor import adafactor
from .adamw import adamw
from .clip import clip_by_global_norm, global_norm
from .schedule import warmup_cosine

__all__ = ["adamw", "adafactor", "clip_by_global_norm", "global_norm", "warmup_cosine"]
