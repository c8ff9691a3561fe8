"""Trace-and-compile frontend: element-wise PIM programs from plain Python.

Users write functions over typed tracers and get back a compiled multi-op
PIM program (DESIGN.md §3):

    import repro_torch.pim as pim

    mac = pim.compile(lambda a, b, c: a * b + c, dtype=pim.f32)
    out = mac(x, y, z)                      # bit-exact, on the GPU
    out = mac(x, y, z, device="cpu")        # the plain versions, on the CPU
    rep = mac.cost(basis="dram")            # program-level CostReport

Tracing works like ``jax.jit`` in the reference package: the function runs once with :class:`Tracer`
arguments whose arithmetic operators append ops to a :class:`Trace`; the
result is an ``ir.Program`` whose per-op ``aritpim`` netlists are recorded
into **one** ScheduleIR — output values of one op wired directly into the
next, so intermediate planes never round-trip through HBM, and the compiler
passes (fold/cse/fuse/dce/reorder) fire across op boundaries.  Netlists are
picked by the tracer's :class:`~repro_torch.core.bitplanes.PimType` via the
``aritpim.OpSpec`` dtype metadata.  Python scalars mixed into the trace
(``a * b + 2.5``) lower to immediate INIT0/INIT1 constant planes
(``ir.CONST_OP``) — they cost no HBM input traffic and constant folding
sees straight through them.

A single-op trace canonicalizes to ``ir.Program.single``, so e.g.
``pim.compile(lambda a, b: a + b, dtype=pim.f32)`` shares its compile-cache
entry with ``ir.compile_op("float_add")`` and every legacy wrapper.

Execution runs on the CUDA device unless the caller passes
``device="cpu"``; with no card and no ``device="cpu"`` a call raises
``RuntimeError`` rather than quietly running on the CPU.
"""

from __future__ import annotations

import dataclasses
import inspect
import re
from typing import Sequence

import torch

from repro_torch.core import aritpim, ir, spans
from repro_torch.core.bitplanes import PimType, num_words


class TraceError(TypeError):
    """Raised for untraceable operations (mixed dtypes, non-scalar
    constants, ...)."""


def _encode_scalar(value, dtype: PimType) -> int:
    """A Python scalar's LSB-first bit pattern in ``dtype``'s plane layout.

    Reuses the exact ``PimType`` pack path (cast + ``to_planes`` on a
    one-element array), so constants round/wrap exactly like runtime data:
    floats go through IEEE/bf16 rounding, fixed-point wraps two's-complement
    to ``nbits``.  Non-integral constants are rejected for fixed types."""
    if dtype.kind == "fixed":
        if isinstance(value, float) and not value.is_integer():
            raise TraceError(
                f"constant {value!r} is not representable in {dtype.name}: "
                "fixed-point programs take integral constants only")
        # Wrap to the signed two's-complement representative so the int32
        # carrier accepts it at every width (a raw 32-bit mask of a negative
        # constant would overflow int32).
        v = int(value) & ((1 << dtype.nbits) - 1)
        if v >= 1 << (dtype.nbits - 1):
            v -= 1 << dtype.nbits
        value = torch.tensor([v], dtype=torch.int32)
    else:
        # Go through Python float first: an int like 2**35 is exactly what
        # float rounding is for, but would overflow the default int32 path.
        try:
            value = float(value)
        except OverflowError:
            raise TraceError(
                f"constant {value!r} overflows {dtype.name}") from None
        # Rounds to float32 first, then to the type, as runtime data does.
        value = torch.tensor([value], dtype=torch.float64)
    planes = dtype.to_planes(dtype.cast(value, device="cpu"))
    return sum((int(p[0]) & 1) << k for k, p in enumerate(planes))


@dataclasses.dataclass(frozen=True)
class Tracer:
    """A typed abstract value flowing through a traced function."""

    trace: "Trace"
    id: int
    dtype: PimType

    def _bin(self, other, arith: str, reverse: bool = False) -> "Tracer":
        if isinstance(other, (int, float, bool)):
            # Scalar constants lower to INIT0/INIT1 immediate planes — they
            # never become HBM inputs (ir.CONST_OP).
            other = self.trace.constant(other, self.dtype)
        if not isinstance(other, Tracer):
            raise TraceError(
                f"cannot apply {arith!r} to a tracer and {type(other).__name__}: "
                "only Python scalars and tracers of the same dtype combine"
            )
        if other.trace is not self.trace:
            raise TraceError("tracers from different traces cannot be combined")
        if other.dtype != self.dtype:
            raise TraceError(
                f"dtype mismatch in {arith!r}: {self.dtype.name} vs "
                f"{other.dtype.name} (no implicit promotion)"
            )
        a, b = (other, self) if reverse else (self, other)
        return self.trace.emit(arith, a, b)

    def __add__(self, other):
        return self._bin(other, "add")

    def __radd__(self, other):
        return self._bin(other, "add", reverse=True)

    def __sub__(self, other):
        return self._bin(other, "sub")

    def __rsub__(self, other):
        return self._bin(other, "sub", reverse=True)

    def __mul__(self, other):
        return self._bin(other, "mul")

    def __rmul__(self, other):
        return self._bin(other, "mul", reverse=True)

    def __truediv__(self, other):
        return self._bin(other, "div")

    def __rtruediv__(self, other):
        return self._bin(other, "div", reverse=True)


class Trace:
    """Accumulates the op graph while the traced function runs."""

    def __init__(self):
        self.in_types: list[PimType] = []
        self.body: list[ir.ProgramOp] = []
        self._next_id = 0
        self._consts: dict[tuple[int, str], Tracer] = {}

    def _fresh(self) -> int:
        v = self._next_id
        self._next_id += 1
        return v

    def input(self, dtype: PimType) -> Tracer:
        assert not self.body, "inputs must be declared before any op"
        self.in_types.append(dtype)
        return Tracer(self, self._fresh(), dtype)

    def constant(self, value, dtype: PimType) -> Tracer:
        """A scalar immediate: one CONST_OP node holding the bit pattern
        (deduplicated per (bits, dtype) so ``a*2 + b*2`` traces one node —
        the dtype is part of the key because two types can share a bit
        pattern, e.g. int16 16256 and bf16 1.0)."""
        bits = _encode_scalar(value, dtype)
        key = (bits, dtype.name)
        hit = self._consts.get(key)
        if hit is not None:
            return hit
        out = self._fresh()
        self.body.append(
            ir.ProgramOp(ir.CONST_OP, (), out, dtype.width, imm=bits))
        tracer = Tracer(self, out, dtype)
        self._consts[key] = tracer
        return tracer

    def emit(self, arith: str, a: Tracer, b: Tracer) -> Tracer:
        op = aritpim.op_for(arith, a.dtype.kind)
        out = self._fresh()
        # Keep dtype.width planes of the result: fixed-point multiplies wrap
        # (low half of the 2n-bit product; DCE deletes the dead high half).
        self.body.append(ir.ProgramOp(op, (a.id, b.id), out, a.dtype.width))
        return Tracer(self, out, a.dtype)


def _canonical_program(trace: Trace, outputs: Sequence[Tracer], name: str) -> ir.Program:
    """Build the ir.Program; single-op full-width traces canonicalize to
    ``Program.single`` so they share cache entries with ``compile_op``."""
    if len(trace.body) == 1 and len(outputs) == 1:
        node = trace.body[0]
        spec = aritpim._OP_TABLE[node.op]
        nbits = trace.in_types[0].nbits
        if (
            node.args == (0, 1)
            and outputs[0].id == node.out
            and len(trace.in_types) == 2
            and tuple(t.width for t in trace.in_types) == spec.in_widths(nbits)
            and node.width == spec.out_width(nbits)
        ):
            return ir.Program.single(node.op, nbits)
    return ir.Program(
        in_widths=tuple(t.width for t in trace.in_types),
        body=tuple(trace.body),
        outputs=tuple(t.id for t in outputs),
        name=name,
    )


def resolve_device(device=None) -> torch.device:
    """The device a call runs on: ``None`` means ``"cuda"``.  Raises
    ``RuntimeError`` for a CUDA device when no card is present — there is
    no silent CPU fallback; pass ``device="cpu"`` to run on the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return device


@dataclasses.dataclass(frozen=True)
class CompiledPimFunction:
    """The compile() artifact: callable + program-level cost reporting.

    Execution and analytics are lazy and cached per ``(basis, passes)`` via
    the ``ir`` compile cache, so constructing one (e.g. at module import in
    ``kernels.ops``) costs only the trace."""

    program: ir.Program
    in_types: tuple[PimType, ...]
    out_types: tuple[PimType, ...]
    backend: str = "cuda"

    def compiled(self, basis: str = "memristive",
                 passes: tuple[str, ...] = ir.DEFAULT_PASSES) -> ir.CompiledSchedule:
        return ir.compile_program(self.program, passes, basis)

    def cost(self, basis: str = "memristive",
             passes: tuple[str, ...] = ir.DEFAULT_PASSES) -> ir.CostReport:
        """Program-level CostReport from the analytical backend."""
        return ir.program_cost(self.program, passes, basis)

    def __call__(self, *arrays, basis: str = "memristive",
                 passes: tuple[str, ...] = ir.DEFAULT_PASSES,
                 backend: str | None = None, device=None,
                 mode: str | None = None):
        """Pack ``arrays`` (tensors or numpy arrays) to planes on ``device``,
        execute, unpack.  Returns tensors on ``device`` (``None`` = CUDA)."""
        if len(arrays) != len(self.in_types):
            raise TypeError(
                f"expected {len(self.in_types)} arrays, got {len(arrays)}")
        device = resolve_device(device)
        with spans.span("pim.call", dtype=self.in_types[0].name, basis=basis) as call:
            cast = []
            for t, x in zip(self.in_types, arrays):
                with spans.span("frontend.cast"):
                    cast.append(t.cast(x, device))
            n = cast[0].shape[0]
            call.set("rows", n)
            # One buffer holds every input plane; to_planes writes each argument's rows.
            planes = torch.empty((sum(t.width for t in self.in_types), num_words(n)),
                                 dtype=torch.int32, device=device)
            i = 0
            for t, x in zip(self.in_types, cast):
                with spans.span("pack.to_planes"):
                    t.to_planes(x, out=planes[i:i + t.width])
                i += t.width
            with spans.span("frontend.compile_cache"):
                compiled = self.compiled(basis, passes)
            name = backend or self.backend
            if mode is not None and not name.startswith("cuda"):
                raise ValueError(
                    f"executor mode {mode!r} only applies to the cuda "
                    f"backends, not {name!r}")
            opts = {} if mode is None else {"mode": mode}
            out = ir.get_backend(name).run(compiled, planes, **opts).planes
            results, i = [], 0
            for t in self.out_types:
                with spans.span("unpack.from_planes"):
                    results.append(t.from_planes(out[i:i + t.width], n))
                i += t.width
        return results[0] if len(results) == 1 else tuple(results)


def trace(fn, dtype) -> CompiledPimFunction:
    """Trace ``fn`` into a Program without committing to a backend."""
    try:
        params = list(inspect.signature(fn).parameters.values())
    except (TypeError, ValueError):  # builtins / C callables
        raise TraceError("cannot inspect the traced function's signature")
    if any(p.kind not in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
           for p in params):
        raise TraceError(
            "traced functions must take plain positional arguments "
            "(*args/**kwargs/keyword-only parameters are not traceable)")
    n_args = len(params)
    if isinstance(dtype, PimType):
        dtypes = (dtype,) * n_args
    else:
        dtypes = tuple(dtype)
        if len(dtypes) != n_args:
            raise TraceError(
                f"{len(dtypes)} dtypes for a {n_args}-argument function")
    t = Trace()
    args = [t.input(d) for d in dtypes]
    result = fn(*args)
    outs = result if isinstance(result, (tuple, list)) else (result,)
    if not outs or not all(isinstance(o, Tracer) and o.trace is t for o in outs):
        raise TraceError("the traced function must return its tracer value(s)")
    name = re.sub(r"[^A-Za-z0-9_]", "", getattr(fn, "__name__", "")) or "program"
    program = _canonical_program(t, outs, name)
    return CompiledPimFunction(
        program=program,
        in_types=dtypes,
        out_types=tuple(o.dtype for o in outs),
    )


def compile(fn, dtype, backend: str = "cuda") -> CompiledPimFunction:  # noqa: A001
    """Trace-and-compile an element-wise PIM program (the public API).

    ``dtype`` is one :class:`PimType` for all arguments or a sequence of
    per-argument types (both operands of every op must agree — there is no
    implicit promotion).  The returned function packs arrays to bit-planes,
    executes the fused program on the requested executor backend (``cuda``
    by default: the CUDA kernels for CUDA tensors, their plain PyTorch
    versions for ``device="cpu"``) and unpacks the result;
    ``.cost(basis=...)`` prices it analytically on either basis.
    """
    return dataclasses.replace(trace(fn, dtype), backend=backend)
