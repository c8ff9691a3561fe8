"""Plain PyTorch oracles for every kernel: the bit-serial executors and
their arithmetic, and the matmul."""

from __future__ import annotations

import torch

from repro_torch.core.machine import Schedule, execute_schedule


def bitserial_ref(schedule: Schedule, planes: torch.Tensor) -> torch.Tensor:
    """Oracle for pim_bitserial: per-gate schedule execution on packed planes.

    planes: [n_inputs, W] int32 stacked in sorted input-name order."""
    split = {}
    i = 0
    for n in sorted(schedule.input_cols):
        k = len(schedule.input_cols[n])
        split[n] = [planes[i + j] for j in range(k)]
        i += k
    out = execute_schedule(schedule, split, n_words=planes.shape[1])
    return torch.stack([p for n in sorted(schedule.output_cols) for p in out[n]])


def float_add_ref(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Semantic oracle: IEEE-754 float32 addition."""
    return x.to(torch.float32) + y.to(torch.float32)


def float_mul_ref(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32) * y.to(torch.float32)


def fixed_add_ref(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Wrapping int32 addition."""
    return x.to(torch.int32) + y.to(torch.int32)


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Oracle for pim_matmul: batched einsum with float32 accumulation."""
    return torch.einsum("gmk,gkn->gmn", a.float(), b.float()).to(a.dtype)
