"""Abstract digital-PIM machine (paper Fig 1e) and the PlaneVM gate DSL.

The machine is a set of crossbar arrays; one column-parallel logic gate
executes per cycle across *all* crossbars simultaneously.  Two gate bases
are modeled, matching the paper:

* **memristive** (MAGIC stateful logic): 2-input NOR (+ FALSE init).  Every
  gate costs ``CYCLES_PER_GATE_MEMRISTIVE = 2`` cycles (output-column
  initialization + evaluation).
* **dram** (SIMDRAM-style): MAJ3/NOT via triple-row activation.  The
  ``dram`` :class:`LogicBasis` lowers NOR schedules to MAJ3/NOT programs
  (``ir.lower_to_dram``) and costs them in row commands — each MAJ3 is 3
  operand-copy AAPs + 1 triple-row activation + 1 result AAP, each NOT 2
  AAPs through the dual-contact rows.

``PlaneVM`` is the single source of truth for arithmetic algorithms: the
same algorithm code runs in

* **execute** mode — planes are packed int32 tensors; bitwise ops give a
  bit-exact simulation while the gate counter accumulates the analytical
  cost; and
* **record** mode — planes are symbolic column ids; the VM emits a flat NOR
  ``Schedule``.  Recorded schedules are SSA (every gate writes a fresh
  column) and feed the compiler pipeline in ``repro_torch.core.ir``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from .bitplanes import as_int32_words

CYCLES_PER_GATE_MEMRISTIVE = 2  # MAGIC: init + evaluate
CYCLES_PER_GATE_DRAM = 2  # retired clock-scaled parity; kept for comparisons

# Schedule opcodes.  Rows are ``(op, a, b, c, out)``; NOR reads (a, b), MAJ3
# reads (a, b, c), NOT/COPY read (a), INIT0/INIT1 read nothing.  The CUDA
# executors (kernels/csrc/bitserial_loop.cu, kernels/bitserial_codegen.py)
# use the same numbers.
OP_NOR = 0
OP_INIT0 = 1
OP_INIT1 = 2
OP_COPY = 3  # buffered copy (2 NOTs fused / 1 AAP); costs one gate slot
OP_NOT = 4  # dram-native inversion (dual-contact row AAP pair)
OP_MAJ3 = 5  # dram-native 3-input majority (triple-row activation)

OP_WIDTH = 5  # columns per schedule row


def operand_slots(op: int) -> tuple[int, ...]:
    """Which of the (a, b, c) fields an opcode actually reads (0-indexed)."""
    if op == OP_NOR:
        return (0, 1)
    if op == OP_MAJ3:
        return (0, 1, 2)
    if op in (OP_COPY, OP_NOT):
        return (0,)
    return ()


def widen_ops(ops: np.ndarray) -> np.ndarray:
    """Normalize an op array to the 5-column ``(op, a, b, c, out)`` layout.

    Legacy 4-column ``(op, a, b, out)`` rows (NOR-basis only) get a zero
    ``c`` operand spliced in before the output column."""
    ops = np.asarray(ops, dtype=np.int32)
    if ops.size == 0:
        return ops.reshape(-1, OP_WIDTH)
    if ops.shape[1] == OP_WIDTH:
        return ops
    assert ops.shape[1] == 4, ops.shape
    wide = np.zeros((ops.shape[0], OP_WIDTH), dtype=np.int32)
    wide[:, :3] = ops[:, :3]
    wide[:, 4] = ops[:, 3]
    return wide


@dataclasses.dataclass(frozen=True)
class LogicBasis:
    """One digital-PIM gate basis: which opcodes are native logic gates and
    what each schedule row costs in that technology's command cycles.

    * ``memristive`` — MAGIC stateful logic: NOR is the native gate; every
      row costs 2 cycles (output-column FALSE init + evaluation).
    * ``dram`` — SIMDRAM-style triple-row activation: MAJ3/NOT are native.
      A MAJ3 row costs 3 operand AAPs + 1 TRA + 1 result AAP; NOT costs 2
      AAPs (through a dual-contact row); COPY/INIT are single AAPs.
    """

    name: str
    gate_opcodes: frozenset[int]  # rows counted as native logic gates
    op_cycles: tuple[tuple[int, int], ...]  # opcode -> row-command cycles
    compute_rows: int = 0  # reserved rows (TRA group, DCC pair, constants)

    def cycles_for(self, op: int) -> int:
        return dict(self.op_cycles)[op]

    def schedule_cycles(self, ops: np.ndarray) -> int:
        """Total command cycles of a compiled op array under this basis."""
        ops = widen_ops(ops)
        table = dict(self.op_cycles)
        codes, counts = np.unique(ops[:, 0], return_counts=True)
        return int(sum(table[int(c)] * int(n) for c, n in zip(codes, counts)))

    def gate_count(self, ops: np.ndarray) -> int:
        ops = widen_ops(ops)
        return int(np.isin(ops[:, 0], list(self.gate_opcodes)).sum())


MEMRISTIVE_BASIS = LogicBasis(
    name="memristive",
    gate_opcodes=frozenset({OP_NOR}),
    op_cycles=(
        (OP_NOR, CYCLES_PER_GATE_MEMRISTIVE),
        (OP_INIT0, CYCLES_PER_GATE_MEMRISTIVE),
        (OP_INIT1, CYCLES_PER_GATE_MEMRISTIVE),
        (OP_COPY, CYCLES_PER_GATE_MEMRISTIVE),
    ),
    compute_rows=0,
)

DRAM_BASIS = LogicBasis(
    name="dram",
    gate_opcodes=frozenset({OP_MAJ3, OP_NOT}),
    op_cycles=(
        (OP_MAJ3, 5),  # 3 operand-copy AAPs + 1 TRA + 1 result AAP
        (OP_NOT, 2),  # AAP into the DCC row + negated AAP out
        (OP_COPY, 1),  # single AAP
        (OP_INIT0, 1),  # AAP from the reserved all-zeros row
        (OP_INIT1, 1),  # AAP from the reserved all-ones row
    ),
    # 3 TRA compute rows + 2 dual-contact rows + all-0/all-1 constant rows.
    compute_rows=7,
)

BASES: dict[str, LogicBasis] = {b.name: b for b in (MEMRISTIVE_BASIS, DRAM_BASIS)}


def get_basis(basis: str | LogicBasis) -> LogicBasis:
    if isinstance(basis, LogicBasis):
        return basis
    return BASES[basis]


@dataclasses.dataclass
class Schedule:
    """A flat column-op program: one row per gate, ``(op, a, b, c, out)``.

    Legacy 4-column ``(op, a, b, out)`` arrays are widened on construction."""

    ops: np.ndarray  # [G, 5] int32
    num_cols: int
    input_cols: dict[str, list[int]]
    output_cols: dict[str, list[int]]

    def __post_init__(self):
        self.ops = widen_ops(self.ops)

    @property
    def num_gates(self) -> int:
        return int(self.ops.shape[0])

    def cycles(self, cycles_per_gate: int = CYCLES_PER_GATE_MEMRISTIVE) -> int:
        return self.num_gates * cycles_per_gate


class PlaneVM:
    """Gate-level DSL over bit-planes.

    mode='execute': plane values are int32 tensors [W] on ``device``; ops
    evaluated eagerly.
    mode='record' : plane values are int column ids; ops appended to a program.
    """

    def __init__(self, mode: str = "execute", n_words: int | None = None,
                 device: str | torch.device = "cpu"):
        assert mode in ("execute", "record")
        self.mode = mode
        self.n_words = n_words
        self.device = torch.device(device)
        self.gates = 0  # NOR-equivalent gate count (the paper's cost unit)
        self._not_cache: dict[int, Any] = {}
        # record mode state (rows are (op, a, b, c, out))
        self._prog: list[tuple[int, int, int, int, int]] = []
        self._next_col = 0
        self._const0 = None
        self._const1 = None

    # ---------------------------------------------------------------- helpers
    def _fresh_col(self) -> int:
        c = self._next_col
        self._next_col += 1
        return c

    def input_plane(self, value=None) -> Any:
        """Declare an input plane (record mode allocates a column id)."""
        if self.mode == "record":
            return self._fresh_col()
        assert value is not None
        return as_int32_words(value, self.device)

    def const0(self) -> Any:
        if self.mode == "execute":
            if self._const0 is None:
                self._const0 = torch.zeros((self.n_words,), dtype=torch.int32,
                                           device=self.device)
            return self._const0
        if self._const0 is None:
            self._const0 = self._fresh_col()
            self._prog.append((OP_INIT0, 0, 0, 0, self._const0))
        return self._const0

    def const1(self) -> Any:
        if self.mode == "execute":
            if self._const1 is None:
                self._const1 = torch.full((self.n_words,), -1, dtype=torch.int32,
                                          device=self.device)
            return self._const1
        if self._const1 is None:
            self._const1 = self._fresh_col()
            self._prog.append((OP_INIT1, 0, 0, 0, self._const1))
        return self._const1

    # ------------------------------------------------------------ gate basis
    def nor(self, a, b) -> Any:
        """The primitive memristive gate: 1 gate slot."""
        self.gates += 1
        if self.mode == "execute":
            return ~(a | b)
        out = self._fresh_col()
        self._prog.append((OP_NOR, a, b, 0, out))
        return out

    def maj3(self, a, b, c) -> Any:
        """3-input majority — the dram basis' native gate (1 gate slot)."""
        self.gates += 1
        if self.mode == "execute":
            return (a & b) | (a & c) | (b & c)
        out = self._fresh_col()
        self._prog.append((OP_MAJ3, a, b, c, out))
        return out

    def not_(self, a) -> Any:
        # Execute mode keys on id(); hold a reference to the key object so a
        # freed tensor can never alias a live cache entry via id reuse.
        key = id(a) if self.mode == "execute" else a
        hit = self._not_cache.get(key)
        if hit is not None:
            return hit[1]
        out = self.nor(a, a)
        self._not_cache[key] = (a, out)
        return out

    def or_(self, a, b) -> Any:
        return self.not_(self.nor(a, b))

    def and_(self, a, b) -> Any:
        return self.nor(self.not_(a), self.not_(b))

    def nand(self, a, b) -> Any:
        return self.not_(self.and_(a, b))

    def xnor(self, a, b) -> Any:
        n1 = self.nor(a, b)
        n2 = self.nor(a, n1)
        n3 = self.nor(b, n1)
        return self.nor(n2, n3)

    def xor(self, a, b) -> Any:
        return self.not_(self.xnor(a, b))

    def mux(self, s, x, y) -> Any:
        """s ? x : y == (s AND x) OR (~s AND y)."""
        sx = self.and_(s, x)
        sy = self.and_(self.not_(s), y)
        return self.or_(sx, sy)

    def full_adder(self, a, b, c) -> tuple[Any, Any]:
        """The 9-NOR full adder (paper §3: 9 gates/bit).  Returns (sum, carry)."""
        n1 = self.nor(a, b)
        n2 = self.nor(a, n1)
        n3 = self.nor(b, n1)
        n4 = self.nor(n2, n3)  # XNOR(a, b)
        n5 = self.nor(n4, c)  # (a^b) & ~c
        n6 = self.nor(n5, n1)  # carry = MAJ(a, b, c)
        n7 = self.nor(n4, n5)  # (a^b) & c
        n8 = self.nor(c, n5)
        n9 = self.nor(n7, n8)  # sum = a ^ b ^ c
        return n9, n6

    def half_adder(self, a, b) -> tuple[Any, Any]:
        s = self.xor(a, b)  # 5 gates
        c = self.and_(a, b)  # <=3 gates (NOTs may be cached)
        return s, c

    # ------------------------------------------------------- tree reductions
    def or_tree(self, xs: Sequence[Any]) -> Any:
        xs = list(xs)
        assert xs
        while len(xs) > 1:
            nxt = []
            for i in range(0, len(xs) - 1, 2):
                nxt.append(self.or_(xs[i], xs[i + 1]))
            if len(xs) % 2:
                nxt.append(xs[-1])
            xs = nxt
        return xs[0]

    def nor_tree(self, xs: Sequence[Any]) -> Any:
        """NOT(OR(xs)) — one gate cheaper at the root."""
        xs = list(xs)
        if len(xs) == 1:
            return self.not_(xs[0])
        while len(xs) > 2:
            nxt = []
            for i in range(0, len(xs) - 1, 2):
                nxt.append(self.or_(xs[i], xs[i + 1]))
            if len(xs) % 2:
                nxt.append(xs[-1])
            xs = nxt
        return self.nor(xs[0], xs[1])

    # ------------------------------------------------------------- recording
    def finish_schedule(self, inputs: dict[str, list[int]],
                        outputs: dict[str, list[int]]) -> Schedule:
        assert self.mode == "record"
        ops = np.asarray(self._prog, dtype=np.int32).reshape(-1, OP_WIDTH)
        return Schedule(ops=ops, num_cols=self._next_col, input_cols=inputs,
                        output_cols=outputs)


def execute_schedule(schedule: Schedule, input_planes: dict[str, list],
                     n_words: int) -> dict[str, list[torch.Tensor]]:
    """Execute a column-allocated or recorded schedule on named input planes
    through the ``interpreter`` backend of :mod:`repro_torch.core.ir`."""
    from . import ir

    return ir.execute_named(schedule, input_planes, n_words)
