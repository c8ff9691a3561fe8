"""Atomic, async checkpointing of dicts of tensors."""
