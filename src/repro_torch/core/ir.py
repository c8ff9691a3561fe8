"""Schedule IR: the single compilation artifact between recording and execution.

The paper's cost unit is a *serial NOR-gate schedule* (one column-parallel
gate per cycle).  This module turns the recorded schedule into a real
compiler pipeline (DESIGN.md §3–4):

    PlaneVM record  →  ScheduleIR (SSA)  →  optimization passes  →
    lower (liveness column allocation)  →  CompiledSchedule  →  backend

``ScheduleIR`` is in SSA form: every row ``(op, a, b, out)`` defines a fresh
value id, so passes are simple forward/backward rewrites with a substitution
map.  ``lower`` maps values onto physical crossbar columns with linear-scan
liveness recycling (this absorbs and retires the old
``machine.compress_schedule``) and produces a ``CompiledSchedule`` with
static input/output slot maps.

The pipeline is **basis-parameterized** (``machine.LogicBasis``): ops are
recorded once in the memristive NOR basis, and ``lower_to_dram`` rewrites the
SSA program into the DRAM basis' native MAJ3/NOT gates via majority
identities — the 9-NOR full adder becomes the textbook 3-MAJ/2-NOT form, so
ripple adders never pay the naive per-NOR expansion.  All passes and the
allocator are basis-aware, and per-basis costs (row-command cycles, peak
rows including the reserved DRAM compute rows) replace the old clock-scaled
parity.

The compilation unit is a multi-op :class:`Program` (``compile_program``):
per-op ``aritpim`` netlists are recorded into **one** SSA program with the
output values of each op wired directly into the next, so intermediate
planes never materialize in HBM and fold/cse/fuse/dce plus the liveness
allocator all fire across op boundaries.  ``compile_op`` is the one-op
special case (``Program.single``), sharing the same cache.  Programs are
built by the ``repro_torch.pim`` trace-and-compile frontend.

Beyond the rewrite passes, two *scheduling* passes reorder gates without
changing the DAG: ``levelize`` partitions the program into dependency waves
(mutually independent gates — the paper's intra-array parallelism metric,
``CostReport.parallel_cycles``) and ``reorder`` is a register-pressure-aware
list scheduler that shortens live ranges before the linear-scan allocator,
cutting ``num_cols``/``peak_rows`` (never increasing them — DESIGN.md §5).

Executor backends share one interface (``Backend.run``) and live in a
registry: ``interpreter`` (a per-gate torch loop), ``cuda`` /
``cuda-unrolled`` / ``cuda-loop`` (the CUDA kernels in
``repro_torch.kernels.pim_bitserial``, registered lazily) and ``cost``
(analytical gate/cycle model — no data movement at all).  Compiled schedules are cached
by ``(program, basis, pass_list)`` so every consumer (``kernels.ops``,
``core.simulate``, ``core.analyzer``, benchmarks) pulls from one path.

Registering a new op = one entry in ``aritpim._OP_TABLE``; a new backend =
one ``register_backend`` call.  See DESIGN.md §4 and README.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any

import numpy as np
import torch

from . import spans
from .bitplanes import as_int32_words
from .machine import (
    CYCLES_PER_GATE_MEMRISTIVE,
    OP_COPY,
    OP_INIT0,
    OP_INIT1,
    OP_MAJ3,
    OP_NOR,
    OP_NOT,
    OP_WIDTH,
    LogicBasis,
    Schedule,
    get_basis,
    operand_slots,
    widen_ops,
)

# ---------------------------------------------------------------------------
# IR
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ScheduleIR:
    """SSA gate program: each row defines value ``out`` exactly once."""

    ops: np.ndarray  # [G, 5] int32 (op, a, b, c, out)
    num_values: int
    inputs: dict[str, list[int]]  # name -> value ids (declaration order)
    outputs: dict[str, list[int]]  # name -> value ids
    meta: dict = dataclasses.field(default_factory=dict)
    pass_log: tuple[str, ...] = ()

    @property
    def num_gates(self) -> int:
        return int(self.ops.shape[0])

    @property
    def nor_gates(self) -> int:
        """Rows that are NOR gates — the paper's compute-complexity unit."""
        return int((self.ops[:, 0] == OP_NOR).sum())

    @property
    def maj_gates(self) -> int:
        return int((self.ops[:, 0] == OP_MAJ3).sum())

    def gate_count(self, basis: str | LogicBasis) -> int:
        """Rows that are native logic gates under ``basis``."""
        return get_basis(basis).gate_count(self.ops)


def _row_operands(op: int, a: int, b: int, c: int) -> tuple[int, ...]:
    """Value ids a row actually reads (opcode-dependent arity)."""
    return tuple((a, b, c)[s] for s in operand_slots(op))


def from_schedule(schedule: Schedule) -> ScheduleIR:
    """Lift a freshly *recorded* ``machine.Schedule`` into SSA.

    Recorded schedules are SSA already (the VM allocates a fresh column per
    gate output); column-allocated schedules are not and are rejected.
    """
    ops = widen_ops(schedule.ops)
    defined = set()
    for cols in schedule.input_cols.values():
        defined.update(cols)
    for row in ops:
        out = int(row[4])
        if out in defined:
            raise ValueError(
                "schedule is not SSA (column written twice) — lift before "
                "column allocation, not after"
            )
        defined.add(out)
    return ScheduleIR(
        ops=np.array(ops, dtype=np.int32).reshape(-1, OP_WIDTH),
        num_values=schedule.num_cols,
        inputs={k: list(v) for k, v in schedule.input_cols.items()},
        outputs={k: list(v) for k, v in schedule.output_cols.items()},
    )


# ---------------------------------------------------------------------------
# Pass framework
# ---------------------------------------------------------------------------


def _resolve(subst: dict[int, int], v: int) -> int:
    while v in subst:
        v = subst[v]
    return v


def _finish(ir: ScheduleIR, gates: list[tuple[int, int, int, int, int]],
            subst: dict[int, int], name: str) -> ScheduleIR:
    """Renumber values compactly (inputs first, then kept gates in order)."""
    mapping: dict[int, int] = {}
    new_inputs = {}
    for k, cols in ir.inputs.items():
        ids = []
        for c in cols:
            mapping[c] = len(mapping)
            ids.append(mapping[c])
        new_inputs[k] = ids
    new_gates = []
    for op, a, b, c, out in gates:
        row = [op, 0, 0, 0, 0]
        for s in operand_slots(op):
            row[1 + s] = mapping[(a, b, c)[s]]
        mapping[out] = len(mapping)
        row[4] = mapping[out]
        new_gates.append(tuple(row))
    new_outputs = {
        k: [mapping[_resolve(subst, v)] for v in vs] for k, vs in ir.outputs.items()
    }
    return ScheduleIR(
        ops=np.asarray(new_gates, dtype=np.int32).reshape(-1, OP_WIDTH),
        num_values=len(mapping),
        inputs=new_inputs,
        outputs=new_outputs,
        meta=dict(ir.meta),
        pass_log=ir.pass_log + (name,),
    )


def fold_constants(ir: ScheduleIR) -> ScheduleIR:
    """INIT/constant folding, basis-aware.

    NOR: a known-1 operand gives INIT0, two known-0s give INIT1, one known-0
    canonicalizes to NOT (helps CSE).  NOT of a constant is the opposite
    INIT.  MAJ3: two constant operands decide the vote (two 1s → INIT1, two
    0s → INIT0, a 1 and a 0 → the remaining operand); two *equal* operands
    decide it too (MAJ(x, x, y) = x)."""
    subst: dict[int, int] = {}
    const: dict[int, int] = {}
    gates: list[tuple[int, int, int, int, int]] = []
    for op, a, b, c, out in ir.ops:
        op, a, b, c, out = int(op), int(a), int(b), int(c), int(out)
        if op in (OP_INIT0, OP_INIT1):
            const[out] = 0 if op == OP_INIT0 else 1
            gates.append((op, 0, 0, 0, out))
        elif op == OP_COPY:
            subst[out] = _resolve(subst, a)
        elif op == OP_NOT:
            a = _resolve(subst, a)
            ca = const.get(a)
            if ca is not None:
                const[out] = 1 - ca
                gates.append((OP_INIT0 if ca == 1 else OP_INIT1, 0, 0, 0, out))
            else:
                gates.append((OP_NOT, a, 0, 0, out))
        elif op == OP_MAJ3:
            a, b, c = (_resolve(subst, v) for v in (a, b, c))
            vals = (a, b, c)
            consts = [const.get(v) for v in vals]
            ones = consts.count(1)
            zeros = consts.count(0)
            if ones >= 2:
                const[out] = 1
                gates.append((OP_INIT1, 0, 0, 0, out))
            elif zeros >= 2:
                const[out] = 0
                gates.append((OP_INIT0, 0, 0, 0, out))
            elif ones == 1 and zeros == 1:
                # the remaining operand decides the vote
                rest = [v for v, cv in zip(vals, consts) if cv is None]
                subst[out] = rest[0]
            elif a == b or a == c:
                subst[out] = a  # MAJ(x, x, y) = x
            elif b == c:
                subst[out] = b
            else:
                gates.append((OP_MAJ3, a, b, c, out))
        else:  # OP_NOR
            a, b = _resolve(subst, a), _resolve(subst, b)
            ca, cb = const.get(a), const.get(b)
            if ca == 1 or cb == 1:
                const[out] = 0
                gates.append((OP_INIT0, 0, 0, 0, out))
            elif ca == 0 and cb == 0:
                const[out] = 1
                gates.append((OP_INIT1, 0, 0, 0, out))
            elif ca == 0:
                gates.append((OP_NOR, b, b, 0, out))
            elif cb == 0:
                gates.append((OP_NOR, a, a, 0, out))
            else:
                gates.append((OP_NOR, a, b, 0, out))
    return _finish(ir, gates, subst, "fold")


def common_subexpr_elim(ir: ScheduleIR, window: int | None = None) -> ScheduleIR:
    """Gate-level CSE by forward value numbering, basis-aware (NOR and MAJ3
    operand orders are normalized — both gates are fully commutative).

    Merging a recomputation reuses an *old* value, extending its live range —
    which can raise the peak column count the allocator must provision.
    ``window`` bounds how far back (in kept gates) a logic gate may be
    reused; ``None`` is unbounded.  ``compile_op`` tightens the window
    adaptively until the schedule fits the unoptimized column budget.
    """
    subst: dict[int, int] = {}
    seen: dict[tuple, tuple[int, int]] = {}  # key -> (value, kept index)
    gates: list[tuple[int, int, int, int, int]] = []
    for op, a, b, c, out in ir.ops:
        op, a, b, c, out = int(op), int(a), int(b), int(c), int(out)
        if op == OP_COPY:
            subst[out] = _resolve(subst, a)
            continue
        if op in (OP_INIT0, OP_INIT1):
            key = (op,)
            a = b = c = 0
        elif op == OP_NOT:
            a = _resolve(subst, a)
            b = c = 0
            key = (OP_NOT, a)
        elif op == OP_MAJ3:
            a, b, c = sorted(_resolve(subst, v) for v in (a, b, c))
            key = (OP_MAJ3, a, b, c)
        else:  # OP_NOR
            a, b = _resolve(subst, a), _resolve(subst, b)
            c = 0
            key = (OP_NOR, min(a, b), max(a, b))
        hit = seen.get(key)
        is_logic = op in (OP_NOR, OP_NOT, OP_MAJ3)
        if hit is not None and (
            not is_logic or window is None or len(gates) - hit[1] <= window
        ):
            subst[out] = hit[0]
            continue
        seen[key] = (out, len(gates))
        gates.append((op, a, b, c, out))
    return _finish(ir, gates, subst, "cse" if window is None else f"cse@{window}")


def fuse_copies(ir: ScheduleIR) -> ScheduleIR:
    """COPY/NOT fusion: COPYs are propagated away and NOT(NOT(x)) folds to x
    in either basis representation — ``NOR(v, v)`` or native ``OP_NOT`` (the
    record-mode not-cache catches most, but CSE/fold/basis-lowering expose
    more)."""
    subst: dict[int, int] = {}
    defs: dict[int, tuple] = {}
    gates: list[tuple[int, int, int, int, int]] = []

    def inverted_input(v: int) -> int | None:
        """x if value ``v`` is NOT(x) in either representation, else None."""
        d = defs.get(v)
        if d is None:
            return None
        if d[0] == OP_NOT or (d[0] == OP_NOR and d[1] == d[2]):
            return d[1]
        return None

    for op, a, b, c, out in ir.ops:
        op, a, b, c, out = int(op), int(a), int(b), int(c), int(out)
        if op == OP_COPY:
            subst[out] = _resolve(subst, a)
            continue
        if op == OP_NOR:
            a, b = _resolve(subst, a), _resolve(subst, b)
            if a == b:
                inner = inverted_input(a)
                if inner is not None:
                    subst[out] = inner  # NOT(NOT(x)) == x
                    continue
            gates.append((OP_NOR, a, b, 0, out))
            defs[out] = (OP_NOR, a, b)
        elif op == OP_NOT:
            a = _resolve(subst, a)
            inner = inverted_input(a)
            if inner is not None:
                subst[out] = inner
                continue
            gates.append((OP_NOT, a, 0, 0, out))
            defs[out] = (OP_NOT, a)
        elif op == OP_MAJ3:
            a, b, c = (_resolve(subst, v) for v in (a, b, c))
            gates.append((OP_MAJ3, a, b, c, out))
            defs[out] = (OP_MAJ3, a, b, c)
        else:
            gates.append((op, 0, 0, 0, out))
            defs[out] = (op, 0)
    return _finish(ir, gates, subst, "fuse")


def dead_gate_elim(ir: ScheduleIR) -> ScheduleIR:
    """Drop gates whose results can never reach an output plane."""
    live = {v for cols in ir.outputs.values() for v in cols}
    keep = np.zeros(ir.num_gates, dtype=bool)
    for g in range(ir.num_gates - 1, -1, -1):
        op, a, b, c, out = (int(x) for x in ir.ops[g])
        if out in live:
            keep[g] = True
            live.update(_row_operands(op, a, b, c))
    gates = [tuple(int(x) for x in row) for row in ir.ops[keep]]
    return _finish(ir, gates, {}, "dce")


# ---------------------------------------------------------------------------
# Gate scheduling: dependency waves + register-pressure-aware reordering
# ---------------------------------------------------------------------------


def _gate_rows(ir: ScheduleIR) -> list[tuple[int, int, int, int, int]]:
    return [tuple(int(x) for x in row) for row in ir.ops]


def _dataflow_waves(gates) -> list[int]:
    """1-based dependency wave per gate: ``wave = 1 + max(operand waves)``.

    Gates in the same wave are mutually independent, so a machine that can
    fire every array column-op concurrently finishes the schedule in
    ``max(waves)`` steps — the paper's intra-array gate-parallelism bound
    (``CostReport.parallel_cycles``).  Inputs sit at wave 0.  The metric is
    a DAG property: reordering passes never change it.
    """
    wave_of: dict[int, int] = {}
    waves = []
    for op, a, b, c, out in gates:
        w = 1 + max((wave_of.get(v, 0) for v in _row_operands(op, a, b, c)),
                    default=0)
        wave_of[out] = w
        waves.append(w)
    return waves


def levelize(ir: ScheduleIR) -> ScheduleIR:
    """Partition the SSA gate DAG into dependency waves and reorder the
    schedule wave-major (stable within a wave).

    The wave count is the paper's intra-array parallelism metric — it flows
    to ``CostReport.parallel_cycles`` — and wave-major order groups mutually
    independent gates contiguously, which is the layout the straight-line CUDA
    executor's read-then-write chunks like best.  Topological order is
    preserved by construction: every operand's wave is strictly smaller
    than its gate's wave.
    """
    gates = _gate_rows(ir)
    waves = _dataflow_waves(gates)
    order = sorted(range(len(gates)), key=lambda g: (waves[g], g))
    out = _finish(ir, [gates[g] for g in order], {}, "levelize")
    out.meta["num_waves"] = max(waves, default=0)
    return out


def _peak_live(gates, input_ids, protected) -> int:
    """Peak simultaneously-live values for a gate order — exactly the
    ``num_cols`` the linear-scan allocator in :func:`lower` will produce
    (inputs allocated up front, outputs pinned, operands freed after their
    last use)."""
    last_use: dict[int, int] = {}
    for g, (op, a, b, c, _out) in enumerate(gates):
        for v in _row_operands(op, a, b, c):
            last_use[v] = g
    live = set(input_ids)
    peak = len(live)
    for g, (op, a, b, c, out) in enumerate(gates):
        live.add(out)
        peak = max(peak, len(live))
        for v in _row_operands(op, a, b, c):
            if last_use.get(v, -1) == g and v in live and v not in protected:
                live.discard(v)
    return peak


REORDER_WINDOW = 256  # how far ahead of program order a freeing gate may hoist


def reorder_pressure(ir: ScheduleIR, window: int = REORDER_WINDOW) -> ScheduleIR:
    """Register-pressure-aware list scheduler (pass name ``reorder``).

    The recorded netlist order is already live-range-friendly (builders emit
    ripple structure depth-first), so global greedy schedulers lose to it;
    instead this pass *follows* program order and only hoists a ready gate
    from the next ``window`` rows when doing so strictly shrinks the live
    set now (it frees more operand columns than the one column it defines).
    The result is kept only if its allocator high-water mark
    (:func:`_peak_live`, = ``lower``'s ``num_cols``) is strictly better than
    the incoming order's — the pass can never increase peak columns.
    """
    gates = _gate_rows(ir)
    n = len(gates)
    operands = [set(_row_operands(op, a, b, c)) for op, a, b, c, _ in gates]
    defs = {g[4]: i for i, g in enumerate(gates)}
    protected = {v for cols in ir.outputs.values() for v in cols}
    input_ids = [v for cols in ir.inputs.values() for v in cols]

    uses: dict[int, int] = {}
    for ops_ in operands:
        for v in ops_:
            uses[v] = uses.get(v, 0) + 1
    consumers: dict[int, list[int]] = {}
    pending = [0] * n
    for i, ops_ in enumerate(operands):
        for v in ops_:
            if v in defs:
                consumers.setdefault(defs[v], []).append(i)
                pending[i] += 1
    ready = [pending[i] == 0 for i in range(n)]
    scheduled = [False] * n

    order: list[int] = []
    nxt = 0  # next unscheduled gate in program order
    while len(order) < n:
        while scheduled[nxt]:
            nxt += 1
        best, best_net = nxt, 0
        for i in range(nxt + 1, min(nxt + window + 1, n)):
            if scheduled[i] or not ready[i]:
                continue
            freed = sum(
                1 for v in operands[i] if uses[v] == 1 and v not in protected)
            if freed - 1 > best_net:  # frees more than the value it defines
                best, best_net = i, freed - 1
        i = best
        scheduled[i] = True
        order.append(i)
        for v in operands[i]:
            uses[v] -= 1
        for j in consumers.get(i, []):
            pending[j] -= 1
            if pending[j] == 0:
                ready[j] = True

    reordered = [gates[i] for i in order]
    if _peak_live(reordered, input_ids, protected) >= _peak_live(
            gates, input_ids, protected):
        reordered = gates  # never worse than the incoming order
    return _finish(ir, reordered, {}, "reorder")


# ---------------------------------------------------------------------------
# Basis lowering: NOR → MAJ3/NOT (the dram basis)
# ---------------------------------------------------------------------------

# The 9-NOR full adder as recorded by machine.PlaneVM.full_adder — gates are
# emitted contiguously, so the cluster can be matched by shape.  Row k's
# operands are given as indices into (x, y, cin, n1..n9) = (-3, -2, -1, 0..8).
_FA_SHAPE = (
    (-3, -2),  # n1 = NOR(a, b)
    (-3, 0),   # n2 = NOR(a, n1)
    (-2, 0),   # n3 = NOR(b, n1)
    (1, 2),    # n4 = NOR(n2, n3)
    (3, -1),   # n5 = NOR(n4, c)
    (4, 0),    # n6 = NOR(n5, n1)  -> carry
    (3, 4),    # n7 = NOR(n4, n5)
    (-1, 4),   # n8 = NOR(c, n5)
    (6, 7),    # n9 = NOR(n7, n8)  -> sum
)
# Use counts of the internal values n1..n8 *inside* the cluster: a match also
# requires they have no uses outside it (and are not outputs).
_FA_INTERNAL_USES = {0: 3, 1: 1, 2: 1, 3: 2, 4: 3, 6: 1, 7: 1}


def lower_to_dram(ir: ScheduleIR) -> ScheduleIR:
    """Rewrite a NOR-basis SSA program into the DRAM basis (MAJ3/NOT).

    Majority identities used (SIMDRAM-style, DESIGN.md §3):

    * full adder — the recorded 9-NOR cluster becomes the textbook
      majority-form adder: ``carry = MAJ(a, b, c)``, ``sum = MAJ(carry',
      MAJ(a, b, c'), c)`` — 3 MAJ + 2 NOT per bit, so ripple adders do not
      pay the naive per-NOR expansion (and CSE later merges the ``NOT
      carry`` each bit computes with the next bit's ``NOT cin``);
    * ``NOR(x', y') = MAJ(x, y, 0)`` (AND of the uninverted inputs — this is
      how the schoolbook multiplier's partial products stay 1 gate each);
    * ``NOR(x, x) = NOT(x)``;
    * generic ``NOR(x, y) = NOT(MAJ(x, y, 1))``.

    Constants needed by the identities are fresh INIT rows prepended to the
    program (CSE merges them with any recorded INITs).  The result contains
    no ``OP_NOR`` rows; outputs keep their value ids.
    """
    ops = ir.ops
    n = ir.num_gates
    out_vals = {v for cols in ir.outputs.values() for v in cols}
    uses: dict[int, int] = {}
    for g in range(n):
        op, a, b, c, _out = (int(x) for x in ops[g])
        for v in _row_operands(op, a, b, c):
            uses[v] = uses.get(v, 0) + 1

    next_val = ir.num_values

    def fresh() -> int:
        nonlocal next_val
        next_val += 1
        return next_val - 1

    consts: dict[int, int] = {}
    prepend: list[tuple[int, int, int, int, int]] = []

    def const(bit: int) -> int:
        if bit not in consts:
            cid = fresh()
            prepend.append((OP_INIT1 if bit else OP_INIT0, 0, 0, 0, cid))
            consts[bit] = cid
        return consts[bit]

    def match_fa(g: int) -> tuple[int, ...] | None:
        """If rows g..g+8 are a recorded full adder, return (x, y, cin)."""
        if g + 9 > n:
            return None
        if any(int(ops[g + k, 0]) != OP_NOR for k in range(9)):
            return None
        x, y = int(ops[g, 1]), int(ops[g, 2])
        cin = int(ops[g + 4, 2])
        nvals = [int(ops[g + k, 4]) for k in range(9)]
        env = {-3: x, -2: y, -1: cin}
        env.update(enumerate(nvals))
        for k, (ea, eb) in enumerate(_FA_SHAPE):
            if int(ops[g + k, 1]) != env[ea] or int(ops[g + k, 2]) != env[eb]:
                return None
        for k, internal in _FA_INTERNAL_USES.items():
            if uses.get(nvals[k], 0) != internal or nvals[k] in out_vals:
                return None
        return x, y, cin

    new: list[tuple[int, int, int, int, int]] = []
    defs: dict[int, tuple[int, int]] = {}  # value -> (OP_NOT, input)
    g = 0
    while g < n:
        fa = match_fa(g)
        if fa is not None:
            x, y, cin = fa
            carry, s = int(ops[g + 5, 4]), int(ops[g + 8, 4])
            cn, t, nc = fresh(), fresh(), fresh()
            new.append((OP_NOT, cin, 0, 0, cn))
            new.append((OP_MAJ3, x, y, cin, carry))
            new.append((OP_MAJ3, x, y, cn, t))
            new.append((OP_NOT, carry, 0, 0, nc))
            new.append((OP_MAJ3, nc, t, cin, s))
            defs[cn] = (OP_NOT, cin)
            defs[nc] = (OP_NOT, carry)
            g += 9
            continue
        op, a, b, c, out = (int(v) for v in ops[g])
        g += 1
        if op != OP_NOR:
            new.append((op, a, b, c, out))
            if op == OP_NOT:
                defs[out] = (OP_NOT, a)
            continue
        if a == b:
            new.append((OP_NOT, a, 0, 0, out))
            defs[out] = (OP_NOT, a)
            continue
        da, db = defs.get(a), defs.get(b)
        if da is not None and db is not None:
            # NOR(x', y') = x AND y = MAJ(x, y, 0)
            new.append((OP_MAJ3, da[1], db[1], const(0), out))
            continue
        t = fresh()
        new.append((OP_MAJ3, a, b, const(1), t))
        new.append((OP_NOT, t, 0, 0, out))
        defs[out] = (OP_NOT, t)

    lowered = ScheduleIR(
        ops=np.asarray(prepend + new, dtype=np.int32).reshape(-1, OP_WIDTH),
        num_values=next_val,
        inputs={k: list(v) for k, v in ir.inputs.items()},
        outputs={k: list(v) for k, v in ir.outputs.items()},
        meta=dict(ir.meta),
        pass_log=ir.pass_log + ("dram",),
    )
    lowered.meta["basis"] = "dram"
    return lowered


PASS_REGISTRY = {
    "fold": fold_constants,
    "cse": common_subexpr_elim,
    "fuse": fuse_copies,
    "dce": dead_gate_elim,
    "dram": lower_to_dram,
    "levelize": levelize,
    "reorder": reorder_pressure,
}

# fuse after cse exposes new common NORs, so cse runs again before dce;
# reorder runs last so the pressure scheduler sees the final gate set.
DEFAULT_PASSES: tuple[str, ...] = ("fold", "cse", "fuse", "cse", "dce",
                                   "reorder")

# Window ladder tried by compile_op until peak columns fit the unoptimized
# budget.  With CSE disabled entirely (last rung) the remaining passes only
# shrink live ranges, so the ladder always terminates.
CSE_WINDOW_LADDER: tuple[int | None, ...] = (None, 500, 200, 50, -1)


def run_passes(ir: ScheduleIR, passes: tuple[str, ...] = DEFAULT_PASSES,
               cse_window: int | None = None) -> ScheduleIR:
    """Run named passes in order.  ``cse_window`` overrides the reuse window
    of every ``cse`` pass (``-1`` disables NOR merging entirely)."""
    for name in passes:
        if name == "cse" and cse_window is not None:
            ir = common_subexpr_elim(ir, window=cse_window)
        else:
            ir = PASS_REGISTRY[name](ir)
    return ir


# ---------------------------------------------------------------------------
# Lowering: liveness-based column allocation (retires machine.compress_schedule)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CompiledSchedule:
    """Column-machine program with static I/O slot maps — what backends run.

    ``num_cols`` is the linear-scan high-water mark, i.e. the peak number of
    simultaneously live crossbar columns/rows (operands + intermediates); the
    paper's memristive config budgets 1024.  ``peak_rows`` additionally
    counts the basis' reserved compute rows (the DRAM TRA/DCC/constant
    group), which backends never touch but real hardware must provision.
    """

    key: str
    ops: np.ndarray  # [G, 5] int32, columns recycled
    num_cols: int
    input_cols: dict[str, list[int]]
    output_cols: dict[str, list[int]]
    recorded_len: int  # schedule rows as recorded (pre-pass)
    recorded_gates: int  # recorded NOR count (the paper's cost unit)
    basis: str = "memristive"
    pass_log: tuple[str, ...] = ()
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def num_gates(self) -> int:
        return int(self.ops.shape[0])

    @property
    def nor_gates(self) -> int:
        return int((self.ops[:, 0] == OP_NOR).sum())

    @property
    def maj_gates(self) -> int:
        return int((self.ops[:, 0] == OP_MAJ3).sum())

    @property
    def not_gates(self) -> int:
        return int((self.ops[:, 0] == OP_NOT).sum())

    @property
    def native_gates(self) -> int:
        """Rows that are native logic gates under this schedule's basis
        (NOR for memristive; MAJ3 + NOT for dram)."""
        return get_basis(self.basis).gate_count(self.ops)

    @property
    def num_waves(self) -> int:
        """Dependency-wave count of the gate DAG — the schedule's depth if
        every independent gate fired concurrently (``parallel_cycles``)."""
        return int(self.meta.get("num_waves", 0))

    @property
    def peak_live_cols(self) -> int:
        return self.num_cols

    @property
    def peak_rows(self) -> int:
        """Allocation high-water mark + the basis' reserved compute rows."""
        return self.num_cols + get_basis(self.basis).compute_rows

    @property
    def input_slots(self) -> list[int]:
        return [c for name in sorted(self.input_cols) for c in self.input_cols[name]]

    @property
    def output_slots(self) -> list[int]:
        return [c for name in sorted(self.output_cols) for c in self.output_cols[name]]

    def cycles(self, cycles_per_gate: int | None = None) -> int:
        """Command cycles under this schedule's basis (per-opcode weights:
        AAP/TRA counts for dram, init+evaluate for memristive).  Passing an
        explicit ``cycles_per_gate`` forces the legacy uniform costing."""
        if cycles_per_gate is not None:
            return self.num_gates * cycles_per_gate
        return get_basis(self.basis).schedule_cycles(self.ops)

    def to_schedule(self) -> Schedule:
        """Legacy ``machine.Schedule`` view (same ops/column maps)."""
        return Schedule(
            ops=self.ops,
            num_cols=self.num_cols,
            input_cols={k: list(v) for k, v in self.input_cols.items()},
            output_cols={k: list(v) for k, v in self.output_cols.items()},
        )

    @classmethod
    def from_legacy(cls, schedule: Schedule, key: str) -> "CompiledSchedule":
        """Wrap an already-column-allocated ``machine.Schedule`` as-is (no
        passes ran, so recorded == current counts)."""
        ops = widen_ops(schedule.ops)
        return cls(
            key=key,
            ops=ops,
            num_cols=schedule.num_cols,
            input_cols={k: list(v) for k, v in schedule.input_cols.items()},
            output_cols={k: list(v) for k, v in schedule.output_cols.items()},
            recorded_len=int(ops.shape[0]),
            recorded_gates=int((ops[:, 0] == OP_NOR).sum()),
        )


def lower(ir: ScheduleIR, key: str = "", basis: str | LogicBasis = "memristive",
          ) -> CompiledSchedule:
    """Linear-scan allocation of SSA values onto recycled crossbar columns.

    Inputs are allocated first (slots ``0..n_in-1`` in declaration order, the
    contract the executors' static slot maps rely on); output values are
    pinned after their final write.  A gate's output column is allocated
    before its operands are freed, matching MAGIC's requirement that the
    output column be initialized while operands still hold their values.

    Under the ``dram`` basis the allocator also accounts for SIMDRAM's
    compute-row copies: operands are staged into the reserved TRA/DCC rows
    (``LogicBasis.compute_rows``, reported via ``peak_rows``), and the AAP
    copy traffic per opcode is already folded into the basis' cycle weights;
    ``meta["copy_aaps"]`` records the total operand/result AAPs so the cost
    model can report data movement separately from TRA compute."""
    basis = get_basis(basis)
    ops = ir.ops
    n_gates = ops.shape[0]
    last_use: dict[int, int] = {}
    for g in range(n_gates):
        op, a, b, c, _out = (int(x) for x in ops[g])
        for v in _row_operands(op, a, b, c):
            last_use[v] = g
    protected = {v for cols in ir.outputs.values() for v in cols}

    mapping: dict[int, int] = {}
    free: list[int] = []
    next_col = 0

    def alloc(v: int) -> int:
        nonlocal next_col
        if v in mapping:
            return mapping[v]
        if free:
            slot = free.pop()
        else:
            slot = next_col
            next_col += 1
        mapping[v] = slot
        return slot

    # Inputs are allocated first, in declaration order, before any frees —
    # capture their slots now, since non-output inputs are recycled later.
    input_cols = {k: [alloc(c) for c in cols] for k, cols in ir.inputs.items()}

    copy_aaps = 0
    new_ops = np.zeros((n_gates, OP_WIDTH), dtype=np.int32)
    for g in range(n_gates):
        op, a, b, c, out = (int(x) for x in ops[g])
        operands = _row_operands(op, a, b, c)
        row = [op, 0, 0, 0, 0]
        for s in operand_slots(op):
            row[1 + s] = mapping[(a, b, c)[s]]
        row[4] = alloc(out)
        new_ops[g] = row
        if op == OP_MAJ3:
            copy_aaps += len(operands) + 1  # stage into TRA rows + result out
        elif op == OP_NOT:
            copy_aaps += 2  # through the DCC row and back
        for v in operands:
            if last_use.get(v, -1) == g and v in mapping and v not in protected:
                free.append(mapping.pop(v))

    # Always recomputed here (O(G)) rather than trusted from pass meta: a
    # pass running after levelize may have changed the gate set.
    num_waves = max(_dataflow_waves(_gate_rows(ir)), default=0)
    return CompiledSchedule(
        key=key,
        ops=new_ops,
        num_cols=next_col,
        input_cols=input_cols,
        output_cols={k: [mapping[c] for c in v] for k, v in ir.outputs.items()},
        recorded_len=int(ir.meta.get("recorded_len", n_gates)),
        recorded_gates=int(ir.meta.get("recorded_gates", ir.nor_gates)),
        basis=basis.name,
        pass_log=ir.pass_log,
        meta=dict(ir.meta, copy_aaps=copy_aaps, num_waves=num_waves),
    )


# ---------------------------------------------------------------------------
# Multi-op programs: the compile_program frontend artifact
# ---------------------------------------------------------------------------


CONST_OP = "__const__"  # ProgramOp.op marker for immediate (scalar) planes


@dataclasses.dataclass(frozen=True)
class ProgramOp:
    """One traced op: an ``aritpim._OP_TABLE`` netlist applied to program
    values.  ``args`` and ``out`` are value ids — inputs are ``0..n_in-1``,
    each op defines the next id.  ``width`` is how many planes of the
    builder's result the program keeps (LSB first): fused fixed-point
    multiplies keep ``n`` of the ``2n`` product planes, and DCE then deletes
    the gates that only fed the dropped half.

    ``op == CONST_OP`` defines an immediate instead: ``imm`` holds the
    value's bit pattern (LSB-first, ``width`` planes) and recording lowers
    it to the VM's cached ``OP_INIT0``/``OP_INIT1`` constant planes — a
    traced Python scalar costs at most two INIT rows and **no** HBM input
    planes."""

    op: str
    args: tuple[int, ...]
    out: int
    width: int
    imm: int | None = None


@dataclasses.dataclass(frozen=True)
class Program:
    """A multi-op PIM program: the unit ``compile_program`` compiles.

    The per-op netlists are recorded into **one** SSA program — the output
    values of one op are wired directly into the next, so intermediate
    planes never round-trip through HBM, and fold/cse/fuse/dce and the
    liveness allocator all operate across op boundaries.  Built by the
    ``repro_torch.pim`` tracer; ``Program.single`` wraps one table op (what
    ``compile_op`` compiles).
    """

    in_widths: tuple[int, ...]
    body: tuple[ProgramOp, ...]
    outputs: tuple[int, ...]
    name: str = "program"
    in_names: tuple[str, ...] | None = None
    out_names: tuple[str, ...] | None = None

    def input_names(self) -> tuple[str, ...]:
        """Slot names, chosen so sorted order == declaration order (the
        backend stacking contract); the 2-digit padding bounds programs at
        100 inputs — refuse loudly rather than scramble slots past it."""
        if self.in_names is not None:
            return self.in_names
        assert len(self.in_widths) <= 100, (
            "programs are limited to 100 inputs (zero-padded slot names)")
        return tuple(f"in{i:02d}" for i in range(len(self.in_widths)))

    def output_names(self) -> tuple[str, ...]:
        if self.out_names is not None:
            return self.out_names
        return tuple(f"out{j:02d}" for j in range(len(self.outputs)))

    @property
    def key(self) -> str:
        """Structural cache key: two traces of the same computation share
        one compilation regardless of the function name they came from."""
        ins = ",".join(map(str, self.in_widths))
        body = ";".join(
            f"const[{n.imm:#x}]->v{n.out}:{n.width}" if n.op == CONST_OP
            else f"{n.op}({','.join(map(str, n.args))})->v{n.out}:{n.width}"
            for n in self.body
        )
        outs = ",".join(f"v{v}" for v in self.outputs)
        names = ""
        if self.in_names is not None or self.out_names is not None:
            names = f"|names:{self.input_names()}|{self.output_names()}"
        return f"in:{ins}|{body}|out:{outs}{names}"

    @classmethod
    def single(cls, op: str, nbits: int = 32) -> "Program":
        """The one-op program ``compile_op`` is a special case of.  Keeps the
        legacy ``a``/``b``/``out`` slot names and the full builder width."""
        from . import aritpim

        spec = aritpim._OP_TABLE[op]
        wa, wb = spec.in_widths(nbits)
        return cls(
            in_widths=(wa, wb),
            body=(ProgramOp(op, (0, 1), 2, spec.out_width(nbits)),),
            outputs=(2,),
            name=f"{op}/{nbits}",
            in_names=("a", "b"),
            out_names=("out",),
        )


def record_program(program: Program) -> ScheduleIR:
    """Record a multi-op program into one SSA IR (NOR basis): per-op
    netlists are stitched value-to-value in a single ``PlaneVM``, so the
    record-mode NOT cache, constants and all downstream passes already see
    across op boundaries."""
    from . import aritpim
    from .machine import PlaneVM

    vm = PlaneVM(mode="record")
    env: dict[int, list] = {}
    inputs: dict[str, list[int]] = {}
    for i, (name, w) in enumerate(zip(program.input_names(), program.in_widths)):
        env[i] = [vm.input_plane() for _ in range(w)]
        inputs[name] = env[i]
    for node in program.body:
        if node.op == CONST_OP:
            env[node.out] = [
                vm.const1() if (node.imm >> k) & 1 else vm.const0()
                for k in range(node.width)
            ]
            continue
        spec = aritpim._OP_TABLE[node.op]
        out = list(spec.builder(vm, *[env[a] for a in node.args]))
        assert len(out) >= node.width, (node.op, len(out), node.width)
        env[node.out] = out[: node.width]
    outputs = {
        name: env[v] for name, v in zip(program.output_names(), program.outputs)
    }
    ir = from_schedule(vm.finish_schedule(inputs, outputs))
    ir.meta.update(
        program=program.key, name=program.name,
        recorded_len=ir.num_gates, recorded_gates=vm.gates,
    )
    return ir


def record_op(op: str, nbits: int = 32) -> ScheduleIR:
    """Record an ``aritpim._OP_TABLE`` builder into SSA IR (NOR basis) —
    the one-op special case of :func:`record_program`."""
    ir = record_program(Program.single(op, nbits))
    ir.meta.update(op=op, nbits=nbits)
    return ir


# ---------------------------------------------------------------------------
# Compilation cache: (program, basis, pass_list) → CompiledSchedule
# ---------------------------------------------------------------------------

_COMPILE_CACHE: dict[
    tuple[str, str, tuple[str, ...]], CompiledSchedule
] = {}
_CACHE_STATS = spans.CounterView({"hits": "ir.compile.hits", "misses": "ir.compile.misses"})


def cache_stats() -> dict[str, int]:
    """Compile-cache hits and misses: the counters ``ir.compile.hits`` and
    ``ir.compile.misses`` of :mod:`repro_torch.core.spans`, printed by
    ``benchmarks/torch_smoke.py``.  A miss also records an ``ir.compile``
    span, by which ``pimbench/attribution.py`` counts a call out of
    ``frontend.cache_hit_share`` (calls that found every cache warm)."""
    return dict(_CACHE_STATS)


def compile_program(
    program: Program,
    passes: tuple[str, ...] = DEFAULT_PASSES,
    basis: str | LogicBasis = "memristive",
) -> CompiledSchedule:
    """Record → basis-lower → optimize → allocate a multi-op program, cached
    by ``(program, basis, pass_list)``.

    The column-budget baseline is the *basis-lowered* program allocated with
    no optimization passes, so the CSE window ladder compares like with like
    on both bases."""
    basis = get_basis(basis)
    passes = tuple(passes)
    cache_key = (program.key, basis.name, passes)
    hit = _COMPILE_CACHE.get(cache_key)
    if hit is not None:
        spans.count("ir.compile.hits")
        return hit
    spans.count("ir.compile.misses")
    with spans.span("ir.compile", basis=basis.name):
        compiled = _compile_uncached(program, passes, basis)
    _COMPILE_CACHE[cache_key] = compiled
    return compiled


def _compile_uncached(program: Program, passes: tuple[str, ...],
                      basis: LogicBasis) -> CompiledSchedule:
    recorded = record_program(program)
    if basis.name == "dram":
        recorded = lower_to_dram(recorded)
        recorded.meta["prepass_gates"] = recorded.gate_count(basis)
        recorded.meta["prepass_len"] = recorded.num_gates
    baseline_cols = lower(recorded, basis=basis).num_cols
    # The schedule key must be unique per *structure* (it names jit-static
    # slot maps in the executor registry); the human-readable program name
    # alone could collide across different traced lambdas.
    digest = hashlib.sha1(program.key.encode()).hexdigest()[:8]
    key = (f"{program.name}@{digest}/{basis.name}/"
           f"{'+'.join(passes) if passes else 'raw'}")
    compiled = None
    for window in CSE_WINDOW_LADDER if "cse" in passes else (None,):
        optimized = run_passes(recorded, passes, cse_window=window)
        compiled = lower(optimized, key=key, basis=basis)
        if compiled.num_cols <= baseline_cols:
            break
    compiled.meta["baseline_cols"] = baseline_cols
    return compiled


def compile_op(
    op: str,
    nbits: int = 32,
    passes: tuple[str, ...] = DEFAULT_PASSES,
    basis: str | LogicBasis = "memristive",
) -> CompiledSchedule:
    """Compile one ``_OP_TABLE`` op — the single-op special case of
    :func:`compile_program`, sharing its cache on both bases."""
    return compile_program(Program.single(op, nbits), passes, basis)


# ---------------------------------------------------------------------------
# Executor backends
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CostReport:
    """Analytical cost of one vectored schedule execution (length-independent).

    ``gates`` counts the basis' *native* logic gates actually executed (NOR
    for memristive, MAJ3 + NOT for dram); ``cycles`` uses the basis'
    per-opcode command weights (init+evaluate pairs for MAGIC, AAP/TRA row
    commands for SIMDRAM) — DRAM numbers are independently derived, not
    clock-scaled memristive ones."""

    key: str
    gates: int  # optimized native gate count actually executed
    recorded_gates: int  # recorded NOR count (paper's unit; passes only shrink it)
    schedule_len: int  # optimized rows incl. INITs
    cycles: int  # per-basis command cycles for the whole schedule
    num_cols: int  # peak live columns (liveness high-water mark)
    parallel_cycles: int = 0  # dependency waves: intra-array parallel depth
    cycles_per_gate: int = CYCLES_PER_GATE_MEMRISTIVE
    basis: str = "memristive"
    maj_gates: int = 0  # dram basis: MAJ3 rows (the TRA count)
    not_gates: int = 0  # dram basis: NOT rows (DCC activations)
    peak_rows: int = 0  # num_cols + the basis' reserved compute rows
    copy_aaps: int = 0  # dram basis: operand/result AAP copies
    hbm_planes_in: int = 0  # input bit-planes crossing the array boundary
    hbm_planes_out: int = 0  # output bit-planes crossing the array boundary

    @property
    def hbm_planes(self) -> int:
        """Total bit-planes moved between HBM and the arrays per dispatch —
        the in-memory metric multi-op fusion shrinks: a fused program moves
        only its true inputs/outputs, never the intermediate planes."""
        return self.hbm_planes_in + self.hbm_planes_out


@dataclasses.dataclass
class ExecutionResult:
    planes: torch.Tensor | None  # [n_outputs, W] int32 (None for cost backend)
    cost: CostReport


class Backend:
    """One executor: turns a CompiledSchedule (+ stacked input planes) into
    output planes and/or an analytical cost report."""

    name = "base"

    def run(self, compiled: CompiledSchedule, planes: torch.Tensor | None = None,
            **opts: Any) -> ExecutionResult:
        raise NotImplementedError

    def cost(self, compiled: CompiledSchedule,
             cycles_per_gate: int | None = None) -> CostReport:
        """Per-basis cost; pass ``cycles_per_gate`` to force legacy uniform
        per-row costing (the retired clock-scaling convention)."""
        return CostReport(
            key=compiled.key,
            gates=compiled.native_gates,
            recorded_gates=compiled.recorded_gates,
            schedule_len=compiled.num_gates,
            cycles=compiled.cycles(cycles_per_gate),
            num_cols=compiled.num_cols,
            parallel_cycles=int(compiled.meta.get("num_waves", 0)),
            cycles_per_gate=(
                cycles_per_gate if cycles_per_gate is not None
                else CYCLES_PER_GATE_MEMRISTIVE
            ),
            basis=compiled.basis,
            maj_gates=compiled.maj_gates,
            not_gates=compiled.not_gates,
            peak_rows=compiled.peak_rows,
            copy_aaps=int(compiled.meta.get("copy_aaps", 0)),
            hbm_planes_in=len(compiled.input_slots),
            hbm_planes_out=len(compiled.output_slots),
        )


def interpret(compiled: CompiledSchedule, planes: torch.Tensor) -> torch.Tensor:
    """Per-gate walk over an int32 ``[num_cols, W]`` state on the planes'
    device — the reference semantics every executor must reproduce.

    Non-input columns start at zero; each row overwrites column ``out`` with
    its gate over whole columns.  ``planes`` is ``[n_in, W]`` int32 in
    sorted-name order; returns ``[n_out, W]`` int32."""
    state = torch.zeros((compiled.num_cols, planes.shape[1]), dtype=torch.int32,
                        device=planes.device)
    if compiled.input_slots:
        state[torch.tensor(compiled.input_slots, device=planes.device)] = planes
    for op, a, b, c, o in compiled.ops.tolist():
        if op == OP_NOR:
            state[o] = ~(state[a] | state[b])
        elif op == OP_MAJ3:
            va, vb, vc = state[a], state[b], state[c]
            state[o] = (va & vb) | (va & vc) | (vb & vc)
        elif op == OP_NOT:
            state[o] = ~state[a]
        elif op == OP_INIT0:
            state[o] = 0
        elif op == OP_INIT1:
            state[o] = -1
        else:  # OP_COPY
            state[o] = state[a]
    return state[torch.tensor(compiled.output_slots, dtype=torch.long,
                              device=planes.device)]


class InterpreterBackend(Backend):
    """Reference executor: :func:`interpret` on whatever device the planes
    are on.  Planes are stacked ``[n_in, W]`` int32 in sorted-name order."""

    name = "interpreter"

    def run(self, compiled, planes=None, **opts):
        assert planes is not None, "interpreter needs input planes"
        return ExecutionResult(interpret(compiled, planes), self.cost(compiled))


class CostModelBackend(Backend):
    """Analytical backend: no data movement, just the gate/cycle bookkeeping
    that used to be duplicated across simulate.py and analyzer.py."""

    name = "cost"

    def run(self, compiled, planes=None,
            cycles_per_gate: int | None = None, **opts):
        return ExecutionResult(None, self.cost(compiled, cycles_per_gate))


_BACKENDS: dict[str, Backend] = {}


def register_backend(backend: Backend) -> Backend:
    _BACKENDS[backend.name] = backend
    return backend


def get_backend(name: str) -> Backend:
    if name not in _BACKENDS and name.startswith("cuda"):
        # The CUDA executors (cuda / cuda-unrolled / cuda-loop) register
        # themselves on import; kept lazy so core never depends on kernels.
        import repro_torch.kernels.pim_bitserial  # noqa: F401
    return _BACKENDS[name]


def backend_names() -> list[str]:
    return sorted(_BACKENDS)


register_backend(InterpreterBackend())
register_backend(CostModelBackend())


# ---------------------------------------------------------------------------
# Cost conveniences (consumed by simulate.py / analyzer.py / benchmarks)
# ---------------------------------------------------------------------------


def op_cost(op: str, nbits: int = 32,
            passes: tuple[str, ...] = DEFAULT_PASSES,
            basis: str | LogicBasis = "memristive") -> CostReport:
    return get_backend("cost").run(compile_op(op, nbits, passes, basis)).cost


def program_cost(program: Program,
                 passes: tuple[str, ...] = DEFAULT_PASSES,
                 basis: str | LogicBasis = "memristive") -> CostReport:
    """Program-level analytical cost (the multi-op analogue of ``op_cost``)."""
    return get_backend("cost").run(compile_program(program, passes, basis)).cost


def netlist_gate_counts(nbits: int = 32) -> dict[str, int]:
    """Recorded NOR counts for the Fig-3 op set, keyed like PAPER_GATE_COUNTS
    (plus the sub/div and bf16 entries the paper doesn't calibrate).

    The single compilation path replacing ad-hoc re-recording: counts come
    from the compile cache, so benchmarks/analyzer/simulate all agree.
    """
    def g(op: str, n: int = nbits) -> int:
        return op_cost(op, n).recorded_gates

    return {
        f"fixed{nbits}_add": g("fixed_add"),
        f"fixed{nbits}_sub": g("fixed_sub"),
        f"fixed{nbits}_mul": g("fixed_mul"),
        f"fixed{nbits}_div": g("fixed_div"),
        "float32_add": g("float_add", 32),
        "float32_mul": g("float_mul", 32),
        "float32_div": g("float_div", 32),
        "bf16_add": g("bf16_add", 16),
        "bf16_mul": g("bf16_mul", 16),
    }


def execute_named(schedule: Schedule, input_planes: dict[str, list],
                  n_words: int) -> dict[str, list[torch.Tensor]]:
    """Named-dict execution of a legacy ``machine.Schedule`` via the
    interpreter backend (compat shim behind ``machine.execute_schedule``)."""
    compiled = CompiledSchedule.from_legacy(schedule, key="adhoc")
    names = sorted(compiled.input_cols)
    stacked = []
    for name in names:
        planes = input_planes[name]
        assert len(planes) == len(compiled.input_cols[name]), (
            name, len(planes), len(compiled.input_cols[name]))
        for p in planes:
            p = as_int32_words(p)
            assert p.shape == (n_words,), (name, p.shape, n_words)
            stacked.append(p)
    out = get_backend("interpreter").run(compiled, torch.stack(stacked)).planes
    result: dict[str, list[torch.Tensor]] = {}
    i = 0
    for name in sorted(compiled.output_cols):
        k = len(compiled.output_cols[name])
        result[name] = [out[i + j] for j in range(k)]
        i += k
    return result
