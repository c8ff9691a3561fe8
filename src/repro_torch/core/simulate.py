"""User-facing bit-exact PIM simulation wrappers.

These run the AritPIM plane algorithms in execute mode on packed planes and
convert back to ordinary tensors.  Each call also reports the analytical
cost — which comes from the ``cost`` executor backend over the compiled
Schedule IR (``repro_torch.core.ir``), the same artifact the interpreter
and CUDA backends execute, rather than from ad-hoc per-call gate counters.

Every wrapper takes ``device`` (``None`` = the CUDA card; ``"cpu"`` runs
on the CPU) and returns ``(tensor on that device, OpCost)``.  With no card
and no ``device="cpu"`` a call raises ``RuntimeError``.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from . import aritpim, bitplanes, ir
from .machine import PlaneVM


@dataclasses.dataclass(frozen=True)
class OpCost:
    """Analytical cost of one vectored PIM op (independent of vector length).

    ``gates`` is the recorded NOR count — the paper's latency unit.
    ``optimized_gates``/``peak_cols`` report what the compiled schedule
    actually executes after the IR pass pipeline.  The ``dram_*`` properties
    report the independently derived DRAM-basis compilation of the same
    netlist (MAJ3/NOT gates, AAP/TRA row-command cycles, peak rows including
    the reserved compute-row group) — not clock-scaled memristive numbers.
    They compile lazily on first access (then hit ``ir``'s compile cache),
    so the bit-exact simulation path never pays a second compile.
    """

    name: str
    gates: int  # recorded serial NOR gates (= the paper's latency unit)
    io_bits: int  # input+output bits per element (CC denominator)
    optimized_gates: int = 0  # post-pipeline NOR count (≤ gates)
    peak_cols: int = 0  # peak live crossbar columns after allocation
    op_key: str = ""  # _OP_TABLE key for the per-basis lookups
    nbits: int = 32

    @property
    def compute_complexity(self) -> float:
        """Paper §3: gates per I/O bit."""
        return self.gates / self.io_bits

    @property
    def dram(self) -> "ir.CostReport":
        """The dram-basis CostReport (compiled on first access, then cached)."""
        return ir.op_cost(self.op_key, self.nbits, basis="dram")

    @property
    def dram_gates(self) -> int:  # MAJ3+NOT count
        return self.dram.gates

    @property
    def dram_maj_gates(self) -> int:  # MAJ3 rows alone (the TRA count)
        return self.dram.maj_gates

    @property
    def dram_cycles(self) -> int:  # AAP/TRA row-command cycles
        return self.dram.cycles

    @property
    def dram_peak_rows(self) -> int:  # allocation peak + reserved compute rows
        return self.dram.peak_rows


def _op_cost(name: str, op_key: str, nbits: int) -> OpCost:
    io_bits = aritpim.op_io_bits(op_key, nbits)  # from _OP_TABLE metadata
    rep = ir.op_cost(op_key, nbits)
    return OpCost(name, rep.recorded_gates, io_bits,
                  optimized_gates=rep.gates, peak_cols=rep.num_cols,
                  op_key=op_key, nbits=nbits)


def _device(device) -> torch.device:
    # Imported here: repro_torch.pim imports this package.
    from repro_torch.pim.frontend import resolve_device

    return resolve_device(device)


def _run(fn, nbits_out, arrays, dtype: bitplanes.PimType, device, from_planes):
    """Cast ``arrays`` to ``dtype`` on ``device``, pack, run ``fn`` on an
    execute-mode PlaneVM and unpack its ``nbits_out`` result planes."""
    device = _device(device)
    arrays = [dtype.cast(a, device) for a in arrays]
    n = arrays[0].shape[0]
    vm = PlaneVM(mode="execute", n_words=bitplanes.num_words(n), device=device)
    out = fn(vm, *(dtype.to_planes(a) for a in arrays))
    assert len(out) == nbits_out
    return from_planes(out, n)


def _signed(p, n):
    return bitplanes.planes_to_int(p, n, signed=True)


# -------------------------------------------------------------- fixed point

def fixed_add(x, y, nbits: int = 32, device=None):
    res = _run(aritpim.fixed_add, nbits, (x, y), bitplanes.fixed(nbits), device,
               _signed)
    return res, _op_cost(f"fixed{nbits}_add", "fixed_add", nbits)


def fixed_mul(x, y, nbits: int = 32, device=None):
    res = _run(
        aritpim.fixed_mul_signed, 2 * nbits, (x, y), bitplanes.fixed(nbits), device,
        lambda p, n: _signed(p[:32], n) if nbits * 2 >= 32 else _signed(p, n),
    )
    return res, _op_cost(f"fixed{nbits}_mul", "fixed_mul", nbits)


def fixed_mul_full(x, y, nbits: int = 32, device=None):
    """Full 2N-bit product as (lo, hi) unsigned words (int64 tensors) for
    nbits=32."""
    res = _run(
        aritpim.fixed_mul_signed, 2 * nbits, (x, y), bitplanes.fixed(nbits), device,
        lambda p, n: (bitplanes.planes_to_int(p[:nbits], n, signed=False),
                      bitplanes.planes_to_int(p[nbits:], n, signed=False)),
    )
    return res, _op_cost(f"fixed{nbits}_mul", "fixed_mul", nbits)


def fixed_div(x, y, nbits: int = 32, device=None):
    """Signed division (C truncation semantics); x//0 → implementation-defined."""
    res = _run(
        lambda vm, A, B: aritpim.fixed_div_signed(vm, A, B)[0], nbits, (x, y),
        bitplanes.fixed(nbits), device, _signed,
    )
    return res, _op_cost(f"fixed{nbits}_div", "fixed_div", nbits)


# ------------------------------------------------------------ floating point

def float_add(x, y, device=None):
    res = _run(aritpim.float_add, 32, (x, y), bitplanes.F32, device,
               bitplanes.planes_to_f32)
    return res, _op_cost("float32_add", "float_add", 32)


def float_sub(x, y, device=None):
    res = _run(aritpim.float_sub, 32, (x, y), bitplanes.F32, device,
               bitplanes.planes_to_f32)
    return res, _op_cost("float32_sub", "float_sub", 32)


def float_mul(x, y, device=None):
    res = _run(aritpim.float_mul, 32, (x, y), bitplanes.F32, device,
               bitplanes.planes_to_f32)
    return res, _op_cost("float32_mul", "float_mul", 32)


def float_div(x, y, device=None):
    res = _run(aritpim.float_div, 32, (x, y), bitplanes.F32, device,
               bitplanes.planes_to_f32)
    return res, _op_cost("float32_div", "float_div", 32)


def bf16_add(x, y, device=None):
    res = _run(aritpim.bf16_add, 16, (x, y), bitplanes.BF16, device,
               bitplanes.planes_to_bf16)
    return res, _op_cost("bf16_add", "bf16_add", 16)


def bf16_mul(x, y, device=None):
    res = _run(aritpim.bf16_mul, 16, (x, y), bitplanes.BF16, device,
               bitplanes.planes_to_bf16)
    return res, _op_cost("bf16_mul", "bf16_mul", 16)


# ------------------------------------------------- fused multi-op programs


@functools.lru_cache(maxsize=None)
def _mac_program(dtype):
    """The fused ``a * b + c`` program at a PimType (traced once per type;
    compilations are cached downstream by structure)."""
    import repro_torch.pim as pim

    return pim.trace(lambda a, b, c: a * b + c, dtype)


def mac_cost(dtype=None, basis: str = "memristive",
             passes: tuple[str, ...] | None = None) -> "ir.CostReport":
    """Program-level CostReport of the fused MAC (``a*b + c``) — the
    flagship composed program: one compiled schedule, intermediates never
    leave the array (compare ``hbm_planes`` with separate mul+add
    dispatches).  ``dtype`` is a ``bitplanes.PimType`` (default float32)."""
    return _mac_program(dtype or bitplanes.F32).cost(
        basis=basis, passes=ir.DEFAULT_PASSES if passes is None else passes)


def float_mac(x, y, c, device=None):
    """Fused float32 ``x*y + c``: execute-mode bit-exact oracle (per-op IEEE
    rounding, like the compiled program) + the fused program's CostReport."""
    res = _run(
        lambda vm, X, Y, C: aritpim.float_add(vm, aritpim.float_mul(vm, X, Y), C),
        32, (x, y, c), bitplanes.F32, device, bitplanes.planes_to_f32,
    )
    return res, mac_cost()
