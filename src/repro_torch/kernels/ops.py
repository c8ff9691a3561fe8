"""Public element-wise wrappers — thin aliases over the ``repro_torch.pim``
frontend.

Every ``pim_*`` wrapper is a traced ``repro_torch.pim`` program: the
frontend packs planes via the ``bitplanes.PimType`` layouts, compiles
through the one ``repro_torch.core.ir`` cache and executes on the ``cuda``
backend.  Every wrapper takes ``basis="memristive"|"dram"`` to execute the
NOR or the MAJ3/NOT lowering of the same netlist,
``mode="auto"|"unrolled"|"loop"`` to pick the executor kernel, and
``device`` (``None`` = the GPU; ``"cpu"`` runs the kernels' plain
versions).  ``pim_matmul_op`` is the MatPIM-schedule blocked matmul.
"""

from __future__ import annotations

import functools

import torch

import repro_torch.pim as pim
from repro_torch.pim.frontend import resolve_device

from . import pim_matmul

_ARITH_FNS = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b,
    "div": lambda a, b: a / b,
}


@functools.lru_cache(maxsize=None)
def _fn(arith: str, dtype_name: str, nbits: int) -> pim.CompiledPimFunction:
    dtype = {"f32": pim.f32, "bf16": pim.bf16}.get(dtype_name) or pim.fixed(nbits)
    return pim.compile(_ARITH_FNS[arith], dtype=dtype, backend="cuda")


def pim_float_add(x, y, device=None, basis: str = "memristive",
                  mode: str | None = None):
    return _fn("add", "f32", 32)(x, y, device=device, basis=basis, mode=mode)


def pim_float_sub(x, y, device=None, basis: str = "memristive",
                  mode: str | None = None):
    return _fn("sub", "f32", 32)(x, y, device=device, basis=basis, mode=mode)


def pim_float_mul(x, y, device=None, basis: str = "memristive",
                  mode: str | None = None):
    return _fn("mul", "f32", 32)(x, y, device=device, basis=basis, mode=mode)


def pim_float_div(x, y, device=None, basis: str = "memristive",
                  mode: str | None = None):
    return _fn("div", "f32", 32)(x, y, device=device, basis=basis, mode=mode)


def pim_bf16_add(x, y, device=None, basis: str = "memristive",
                 mode: str | None = None):
    return _fn("add", "bf16", 16)(x, y, device=device, basis=basis, mode=mode)


def pim_bf16_sub(x, y, device=None, basis: str = "memristive",
                 mode: str | None = None):
    return _fn("sub", "bf16", 16)(x, y, device=device, basis=basis, mode=mode)


def pim_bf16_mul(x, y, device=None, basis: str = "memristive",
                 mode: str | None = None):
    return _fn("mul", "bf16", 16)(x, y, device=device, basis=basis, mode=mode)


def pim_fixed_add(x, y, nbits: int = 32, device=None,
                  basis: str = "memristive", mode: str | None = None):
    return _fn("add", "fixed", nbits)(x, y, device=device, basis=basis, mode=mode)


def pim_fixed_sub(x, y, nbits: int = 32, device=None,
                  basis: str = "memristive", mode: str | None = None):
    return _fn("sub", "fixed", nbits)(x, y, device=device, basis=basis, mode=mode)


def pim_fixed_mul(x, y, nbits: int = 32, device=None,
                  basis: str = "memristive", mode: str | None = None):
    """Signed N×N multiply; returns the low N bits (wrapping, like int mul)."""
    return _fn("mul", "fixed", nbits)(x, y, device=device, basis=basis, mode=mode)


def pim_fixed_div(x, y, nbits: int = 32, device=None,
                  basis: str = "memristive", mode: str | None = None):
    """Signed division (C truncation semantics); x//0 is the netlist's
    documented all-ones convention."""
    return _fn("div", "fixed", nbits)(x, y, device=device, basis=basis, mode=mode)


def pim_matmul_op(a, b, *, bm=128, bk=128, bn=128, device=None):
    """Batched ``[G,M,K] @ [G,K,N]`` on ``device`` (``None`` = the GPU):
    ``a`` and ``b`` (tensors or numpy arrays) are moved there first."""
    device = resolve_device(device)
    a, b = torch.as_tensor(a, device=device), torch.as_tensor(b, device=device)
    return pim_matmul.matmul(a, b, bm=bm, bk=bk, bn=bn)


def schedule_info(opname: str, nbits: int = 32, basis: str = "memristive"):
    """(recorded schedule length, allocated columns) — benchmarks/tests."""
    from repro_torch.core import ir

    compiled = ir.compile_op(opname, nbits=nbits, basis=basis)
    return compiled.recorded_len, compiled.num_cols
