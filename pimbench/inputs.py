"""The seeded pool of input sets, made on the device in a few large calls.

float32 inputs take the form of ``f32_inputs`` in the repository's
``chip_smoke.py``: a standard normal mantissa times a power of two drawn
from ``2^-140 .. 2^119`` (so products and sums overflow, underflow into
subnormals and cancel), with ±0, ±inf, NaN, the smallest subnormals, the
smallest normal and the largest finite values at fixed rows of every
argument.  Fixed-point inputs are uniform over the type's range.  The pool
is ``[sets, args, rows]`` in the program's own carrier dtype (float32, or
the smallest integer dtype that holds the type), so the frontend's cast is a
no-op.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference import elem_type

F32_SPECIALS = np.array(
    [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45, 1.1754942e-38,
     3.4028235e38, -3.4028235e38, 1.0, -1.0], dtype=np.float32)


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed % (1 << 64))


def _powers_of_two(exponents: torch.Tensor) -> torch.Tensor:
    """``2.0 ** e`` in float32, exactly, from the bit pattern (normals and
    subnormals alike; no library ``exp2`` rounding or flush to zero)."""
    bits = torch.where(exponents >= -126, (exponents + 127).clamp(min=0) << 23,
                       torch.ones_like(exponents) << (exponents + 149).clamp(0, 22))
    return bits.to(torch.int32).view(torch.float32)


def special_rows(arg: int, rows: int, stride: int) -> np.ndarray:
    """The rows of argument ``arg`` that hold the special values."""
    return arg + np.arange(len(F32_SPECIALS)) * max(stride, 1)


def make_pool(dtype: str, n_args: int, sets: int, rows: int, stride: int, seed: int,
              device) -> torch.Tensor:
    """``[sets, n_args, rows]`` inputs from ``seed``; float32 specials every
    ``stride`` rows, from the top of each set."""
    t = elem_type(dtype)
    g = generator(seed, device)
    shape = (sets, n_args, rows)
    if t.kind == "fixed":
        carrier = (torch.int8 if t.nbits <= 8 else torch.int16 if t.nbits <= 16
                   else torch.int32)
        half = 1 << (t.nbits - 1)
        return torch.randint(-half, half, shape, generator=g, device=device, dtype=carrier)
    pool = torch.empty(shape, device=device, dtype=torch.float32)
    for s in range(sets):  # a set at a time, to keep set-up's peak near the pool's size
        mantissa = torch.randn(shape[1:], generator=g, device=device, dtype=torch.float32)
        exponents = torch.randint(-140, 120, shape[1:], generator=g, device=device,
                                  dtype=torch.int32)
        torch.mul(mantissa, _powers_of_two(exponents), out=pool[s])
        del mantissa, exponents
    for k in range(n_args):
        where = torch.as_tensor(special_rows(k, rows, stride), device=device)
        keep = where < rows
        values = torch.as_tensor(np.roll(F32_SPECIALS, k), device=device)
        pool[:, k, where[keep]] = values[keep]
    return pool
