"""Bit-plane packing for the digital-PIM abstract machine, on torch tensors.

A *bit-plane* is one column of the abstract crossbar (paper Fig 1e): one bit
per memory row.  32 rows pack into one 32-bit word, so a column-parallel
logic gate over ``R`` rows is one bitwise op over ``ceil(R/32)`` words.

The plane carrier is **int32**: the bits are those of the reference's
uint32 words, but ``~``, ``<<`` and ``>>`` are implemented for int32 on
every torch device.  Right shifts here are arithmetic, so every bit
extraction masks with ``& 1`` (a logical shift by masking).

An ``N``-bit number vector is a list of ``N`` planes, LSB first.
:class:`PimType` packages one element type's plane layout (``F32``,
``BF16``, ``fixed(n)``) for the frontend and the executors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

WORD = 32


def num_words(n_elems: int) -> int:
    """Words needed to hold one bit from each of ``n_elems`` rows."""
    return (n_elems + WORD - 1) // WORD


def as_int32_words(value, device=None) -> torch.Tensor:
    """Any 32-bit word array (numpy/torch, int32 or uint32) → int32 tensor
    with the same bits."""
    if isinstance(value, np.ndarray):
        if value.dtype == np.uint32:
            value = value.view(np.int32)
        return torch.as_tensor(value, device=device).to(torch.int32)
    t = torch.as_tensor(value, device=device)
    if t.dtype == torch.uint32:
        return t.view(torch.int32)
    return t.to(torch.int32)


def _lanes(device) -> torch.Tensor:
    return torch.arange(WORD, dtype=torch.int32, device=device)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack a 0/1 vector ``[n]`` into ``[ceil(n/32)]`` int32 words (LSB-first
    in word).  Bit 31 lands in the sign bit; the int32 sum of distinct
    powers of two never overflows, so it equals their OR."""
    bits = torch.as_tensor(bits).to(torch.int32)
    pad = (-bits.shape[0]) % WORD
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    bits = bits.reshape(-1, WORD)
    return (bits << _lanes(bits.device)).sum(dim=1, dtype=torch.int32)


def unpack_bits(words: torch.Tensor, n_elems: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits` → int32 0/1 ``[n_elems]``."""
    bits = (words[:, None] >> _lanes(words.device)) & 1
    return bits.reshape(-1)[:n_elems]


def int_to_planes(x: torch.Tensor, nbits: int) -> list[torch.Tensor]:
    """Two's-complement integer vector ``[n]`` → ``nbits`` packed planes
    (LSB first).  Wider integer types keep their low 32 bits."""
    ux = x.to(torch.int32) if x.dtype != torch.int64 else (
        (x & 0xFFFFFFFF) - ((x & 0x80000000) << 1)).to(torch.int32)
    return [pack_bits((ux >> j) & 1) for j in range(nbits)]


def _planes_to_bits(planes: list[torch.Tensor], n_elems: int) -> torch.Tensor:
    acc = torch.zeros((n_elems,), dtype=torch.int32, device=planes[0].device)
    for j, p in enumerate(planes):
        acc |= unpack_bits(p, n_elems) << j
    return acc


def planes_to_int(planes: list[torch.Tensor], n_elems: int,
                  signed: bool = True) -> torch.Tensor:
    """``nbits`` packed planes → integer vector ``[n_elems]``: int32 two's
    complement when ``signed``, else the unsigned value as int64."""
    nbits = len(planes)
    acc = _planes_to_bits(planes, n_elems)
    if signed:
        if nbits < 32:
            sign = (acc >> (nbits - 1)) & 1
            acc = torch.where(sign == 1, acc | (-1 << nbits), acc)
        return acc
    return acc.to(torch.int64) & 0xFFFFFFFF


def f32_to_planes(x: torch.Tensor) -> list[torch.Tensor]:
    """float32 vector ``[n]`` → 32 packed planes (LSB first: mantissa, exp,
    sign)."""
    return int_to_planes(x.to(torch.float32).contiguous().view(torch.int32), 32)


def planes_to_f32(planes: list[torch.Tensor], n_elems: int) -> torch.Tensor:
    assert len(planes) == 32
    return _planes_to_bits(planes, n_elems).view(torch.float32)


def f32_to_bf16_bits(x: torch.Tensor) -> torch.Tensor:
    """float32 → bfloat16 bit patterns (int32, low 16 bits), round to
    nearest even; NaN keeps its sign and becomes the quiet NaN ``0x7FC0``.
    Done in integer ops so every device rounds identically (torch's own
    cast turns NaN into ``0xFFFF``)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    rounded = ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16) & 0xFFFF
    nan = ((bits >> 16) & 0x8000) | 0x7FC0
    return torch.where(torch.isnan(x.to(torch.float32)), nan, rounded)


def bf16_to_planes(x: torch.Tensor) -> list[torch.Tensor]:
    """bfloat16 vector ``[n]`` → 16 packed planes (LSB first).  A float32
    input is rounded by :func:`f32_to_bf16_bits`."""
    if x.dtype == torch.bfloat16:
        bits = x.contiguous().view(torch.int16).to(torch.int32) & 0xFFFF
    else:
        bits = f32_to_bf16_bits(x)
    return int_to_planes(bits, 16)


def planes_to_bf16(planes: list[torch.Tensor], n_elems: int) -> torch.Tensor:
    assert len(planes) == 16
    acc = _planes_to_bits(planes, n_elems)
    acc = acc - ((acc & 0x8000) << 1)  # sign-extend into int16 range
    return acc.to(torch.int16).view(torch.bfloat16)


# ---------------------------------------------------------------------------
# Typed plane layouts (consumed by repro_torch.pim and kernels/ops.py)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PimType:
    """One PIM element type: plane count + pack/unpack + netlist selection.

    ``kind`` is the key the tracer matches against ``aritpim.OpSpec.dtype``
    (``"fixed"`` | ``"float32"`` | ``"bf16"``); ``width`` is planes per
    element (LSB first); ``nbits`` parameterizes width-generic netlists."""

    name: str
    kind: str
    width: int
    nbits: int

    def cast(self, x, device=None) -> torch.Tensor:
        """Coerce a numpy array or tensor to this type's carrier on
        ``device`` (fixed types keep the caller's integer dtype; bf16 keeps
        bf16 tensors and carries anything else as float32 until packing)."""
        if isinstance(x, np.ndarray) and x.dtype == np.uint32:
            x = x.view(np.int32)
        t = torch.as_tensor(x, device=device)
        if self.kind == "float32":
            return t.to(torch.float32)
        if self.kind == "bf16":
            return t if t.dtype == torch.bfloat16 else t.to(torch.float32)
        if t.is_floating_point():
            raise TypeError(f"{self.name} takes integer arrays, got {t.dtype}")
        return t

    def to_planes(self, x: torch.Tensor) -> list[torch.Tensor]:
        """``[n]`` tensor → ``width`` packed planes (LSB first)."""
        if self.kind == "float32":
            return f32_to_planes(x)
        if self.kind == "bf16":
            return bf16_to_planes(x)
        return int_to_planes(x, self.nbits)

    def from_planes(self, planes: list[torch.Tensor], n_elems: int) -> torch.Tensor:
        """Inverse of :meth:`to_planes` (fixed types decode as signed)."""
        assert len(planes) == self.width, (self.name, len(planes), self.width)
        if self.kind == "float32":
            return planes_to_f32(planes, n_elems)
        if self.kind == "bf16":
            return planes_to_bf16(planes, n_elems)
        return planes_to_int(planes, n_elems, signed=True)


F32 = PimType("f32", "float32", 32, 32)
BF16 = PimType("bf16", "bf16", 16, 16)


def fixed(nbits: int) -> PimType:
    """Two's-complement fixed-point type with ``nbits`` planes."""
    assert 1 <= nbits <= 32
    return PimType(f"fixed{nbits}", "fixed", nbits, nbits)


def np_pack_reference(bits: np.ndarray) -> np.ndarray:
    """NumPy oracle for pack_bits (used by tests): uint32 words."""
    n = bits.shape[0]
    pad = (-n) % WORD
    if pad:
        bits = np.concatenate([bits, np.zeros(pad, dtype=bits.dtype)])
    bits = bits.reshape(-1, WORD).astype(np.uint64)
    shifts = np.arange(WORD, dtype=np.uint64)
    return (bits << shifts).sum(axis=1).astype(np.uint32)
