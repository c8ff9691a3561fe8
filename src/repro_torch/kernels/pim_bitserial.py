"""CUDA executors for bit-serial element-parallel PIM gate schedules.

A crossbar column over R rows is a packed bit-plane of ``R/32`` int32
words; the serial gate schedule becomes a sequence of bitwise ops over
those words.  Both logic bases run here — memristive NOR rows and the DRAM
basis' MAJ3/NOT rows — so one executor serves every ``(program, basis,
passes)`` compile, including fused multi-op programs from the
``repro_torch.pim`` frontend.  Device-memory traffic is the program's
boundary planes only (``CostReport.hbm_planes``).

Two kernels, written by hand for Hopper, port the two Pallas kernels of
``src/repro/kernels/pim_bitserial.py``:

* ``loop`` — ``csrc/bitserial_loop.cu`` (replaces ``_kernel``): each thread
  owns ``LOOP_WORDS_PER_THREAD`` words of a crossbar state in shared memory
  and walks a packed gate table (:func:`pack_rows`: 8 bytes a row, the
  schedule's gates list-scheduled by dataflow into groups of up to
  ``GATE_GROUP``, each reading only values written by earlier groups, so a
  group reads all its operands before it writes).  Any schedule, no
  per-schedule build.  The state is the kernel's own, not the schedule's
  columns: :func:`live_state` gives each value a column only while it is
  live, and inputs are staged, copied in while the stage before their
  first reader runs, not all loaded first.  One block fills an SM's shared
  memory, so that width sets the warps an SM runs
  (:func:`words_per_block`): 4.5 for the nine-tap conv row, whose 672
  schedule columns, 608 of them inputs, gave one.
* ``unrolled`` — generated per schedule by ``bitserial_codegen`` (replaces
  ``_unrolled_segment_kernel``): straight-line code on fixed column
  variables, in hazard-free wave chunks, split into segments of at most
  ``UNROLL_SEGMENT_GATES`` gates with the ``[num_cols, W]`` state threaded
  through device memory between segment launches.

The ``cuda`` backend picks the kernel by gate count
(``UNROLL_AUTO_MAX_GATES``), exactly as the reference's ``pallas`` backend
does; ``cuda-unrolled`` / ``cuda-loop`` force one.  For CUDA tensors the
backends launch the kernel or raise; for CPU tensors they run the kernel's
plain PyTorch version (:func:`loop_plain`, :func:`unrolled_plain`).  Each
kernel's launches are counted in :data:`LAUNCHES`.  The executor's spans
(``exec.run_schedule``, ``exec.launch``, ``exec.build``) and counters are
those of :mod:`repro_torch.core.spans`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import heapq
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import ir, spans
from repro_torch.core.machine import (
    OP_COPY,
    OP_INIT0,
    OP_INIT1,
    OP_MAJ3,
    OP_NOR,
    OP_NOT,
    Schedule,
    operand_slots,
)

from . import _build, bitserial_codegen, pim_bitplanes

BLOCK_WORDS = 256
# Schedules at or below this many gates run straight-line; longer ones run
# the loop kernel (the reference's threshold, so auto mode picks the same
# kernel for every program).
UNROLL_AUTO_MAX_GATES = 1024
# Straight-line gates per generated segment; boundaries snap to wave chunks.
UNROLL_SEGMENT_GATES = 1024
# Dynamic shared memory one block may use on Hopper (227 KB).
SMEM_LIMIT_BYTES = 232_448
# Loop kernel: the most gates a warp issues together (reads all, then writes
# all), rows per shared-memory stage of the gate table (two stages), 32-bit
# words per thread, and the packed row's layout.
GATE_GROUP = 4
ROW_CHUNK = 256
LOOP_WORDS_PER_THREAD = 2
COL_BITS = 12
ROW_BYTES = 8
# A packed row is two 32-bit words of two 16-bit halves, each half a 12-bit
# column index and 4 more bits: (a | op << 12 | invert << 15 | b << 16,
# c | (group size - 1) << 12 | o << 16), the group size on a group's first
# row only.  Every opcode runs as MAJ3(a, b, c) ^ invert, so an operand the
# opcode does not read names one of two constant columns after the live
# state's own: all zeros (``state_cols``) and all ones (``state_cols + 1``).
OP_SHIFT = 12
INVERT_SHIFT = 15
GROUP_SHIFT = 12
HALF_SHIFT = 16
MAX_LOOP_COLS = (1 << COL_BITS) - 2  # and the two constant columns
# The gates the loop kernel's list scheduler fills a group from: the next
# unscheduled ones in program order.  A window of 1024 finds 1 - 2 % fewer
# groups but widens the live state (the dram f32 MAC's to 126 columns).
SCHEDULE_WINDOW = 64

LOOP_SOURCE = Path(__file__).with_name("csrc") / "bitserial_loop.cu"

# Kernel launches on CUDA tensors, one per launch, by kernel: the counters
# ``exec.launches.<kernel>``.
LAUNCHES = spans.CounterView({k: f"exec.launches.{k}"
                              for k in ("bitserial_loop", "bitserial_unrolled")})


def reset_launches() -> None:
    spans.reset_counters("exec.launches.bitserial_")


# ---------------------------------------------------------------------------
# Loop kernel (the `loop` mode)
# ---------------------------------------------------------------------------


def words_per_block(state_cols: int) -> int:
    """Packed words per block of the loop kernel: the largest multiple of 32
    (at most 1024 threads) whose ``[state_cols + 2, words]`` state (with the
    two constant columns) fits in shared memory beside the two gate-table
    stages.  ``state_cols`` is the live state's width
    (:attr:`LoopTable.state_cols`), not the schedule's ``num_cols``.  The
    state takes over half of an SM's shared memory, so an SM runs one block,
    and its width, not the gate count, sets the warps an SM runs: the
    nine-tap conv row's 672 columns gave 64 words, one warp; its 191 live
    ones give 288 words, 4.5 warps."""
    room = SMEM_LIMIT_BYTES - 2 * ROW_CHUNK * ROW_BYTES
    words = min(1024 * LOOP_WORDS_PER_THREAD,
                room // (4 * (max(state_cols, 1) + 2)) // 32 * 32)
    if words < 32:
        raise ValueError(
            f"a {state_cols}-column state does not fit the loop kernel's "
            f"shared memory even at 32 words per block")
    return words


def loop_operands(op: int, a: int, b: int, c: int, num_cols: int) -> tuple[int, int, int, bool]:
    """``(a, b, c, invert)`` with which the loop kernel runs a row as
    ``MAJ3(a, b, c) ^ invert``: NOR(a, b) = ~MAJ3(a, b, 1), NOT(a) =
    ~MAJ3(a, 1, 0), COPY(a) = MAJ3(a, 1, 0), INIT0/INIT1 = MAJ3(0, 0, 0)
    and its inverse, with 0 and 1 the constant columns ``num_cols`` and
    ``num_cols + 1``."""
    zero, ones = num_cols, num_cols + 1
    if op == OP_NOR:
        return a, b, ones, True
    if op == OP_MAJ3:
        return a, b, c, False
    if op in (OP_NOT, OP_COPY):
        return a, ones, zero, op == OP_NOT
    return zero, zero, zero, op == OP_INIT1


# By opcode: which of the (a, b, c) fields it reads; and, from
# loop_operands over stand-ins, which of (a, b, c, zero, ones) the kernel
# reads as each operand, and whether it inverts.
_READS = np.array([[f in operand_slots(op) for f in range(3)] for op in range(8)])
_OPERANDS = np.array([loop_operands(op, 0, 1, 2, 3)[:3] for op in range(8)])
_INVERT = np.array([loop_operands(op, 0, 1, 2, 3)[3] for op in range(8)])


class Dataflow(NamedTuple):
    """A schedule's gates on values (:func:`dataflow`): input ``i`` is value
    ``i``, gate ``g`` writes value ``n_in + g``, and -1 is the zero value."""

    ops: np.ndarray  # [n_gates]: each gate's opcode
    reads: np.ndarray  # [n_gates, 3]: the value each field reads, -1 if the opcode reads none
    n_in: int
    outputs: np.ndarray  # [n_out]: each output's final value


def dataflow(compiled: ir.CompiledSchedule) -> Dataflow:
    """Rename ``compiled``'s rows to values once, in program order: each
    write is a new value, each read the value its column last took before
    the row (an input's, or the zero value if the column was never written:
    the schedule's scratch starts at zero), each output its column's final
    value.  On values the rows may run in any order that keeps their true
    dependences: the kernel's columns are allocated afresh
    (:func:`live_state`)."""
    ops = compiled.ops.astype(np.int64)
    n, n_in = len(ops), len(compiled.input_slots)
    before = np.full(compiled.num_cols, -1)  # each column's value before any write
    before[compiled.input_slots] = np.arange(n_in)
    keys = ops[:, 4] * (n + 1) + np.arange(n)
    by_key = np.argsort(keys)
    keys = keys[by_key]

    def value_at(col, row):
        """The value that column ``col`` holds when row ``row`` reads."""
        pos = np.searchsorted(keys, col * (n + 1) + row) - 1
        hit = pos >= 0
        hit[hit] = keys[pos[hit]] // (n + 1) == col[hit]
        value = before[col]
        value[hit] = n_in + by_key[pos[hit]]
        return value

    reads = np.full((n, 3), -1)
    gate, field = np.nonzero(_READS[ops[:, 0]])
    reads[gate, field] = value_at(ops[gate, 1 + field], gate)
    outputs = value_at(np.asarray(compiled.output_slots, dtype=np.int64), n)
    return Dataflow(ops[:, 0], reads, n_in, outputs)


def loop_groups(flow: Dataflow, cap: int | None = None,
                window: int = SCHEDULE_WINDOW) -> list[list[int]]:
    """The loop kernel's row order: ``flow``'s gates list-scheduled by
    dataflow into groups of at most ``GATE_GROUP`` gate indices.  A gate is
    ready once every value it reads was written in an earlier group, so a
    group read in full before it is written computes what program order
    computes.  Each group takes the earliest ready gates among the next
    ``window`` unscheduled ones in program order; a window of one keeps
    program order.  A group never straddles a ``ROW_CHUNK`` stage, and the
    last stage is filled with one-row groups ``[-1]`` that write zero into
    the zero column.

    ``cap`` bounds the live state's width as :func:`live_state` counts it
    (inputs returned unread aside): a gate is held back while its group
    would take the state past ``cap``, or past the widest it has been if
    that is more, and looked at again once a later gate joins the group,
    since the group's reads free columns before its writes take them.  The
    first unscheduled gate is always ready, and runs if nothing fits, so no
    group is empty."""
    n, n_in = len(flow.ops), flow.n_in
    # Each value's reads not yet in a group.
    left = np.bincount(flow.reads[flow.reads >= 0], minlength=n_in + n).tolist()
    keep = np.zeros(n_in + n, bool)  # returned values never free
    keep[flow.outputs[flow.outputs >= 0]] = True
    keep = keep.tolist()
    # Each gate's distinct values read, with their counts: reads[at[g]:at[g + 1]].
    value, count = flow.reads.copy(), np.ones_like(flow.reads)
    for i, j in ((0, 1), (0, 2), (1, 2)):
        twice = (value[:, j] == value[:, i]) & (value[:, i] >= 0)
        count[twice, i] += 1
        value[twice, j] = -1
    distinct = value >= 0
    reads = list(zip(value[distinct].tolist(), count[distinct].tolist()))
    at = np.append(0, np.cumsum(distinct.sum(axis=1))).tolist()
    # Each gate's consumers, consumers[by[g]:by[g + 1]], and the gates it waits for.
    consumer, field = np.nonzero(value >= n_in)
    producer = value[consumer, field] - n_in
    consumers = consumer[np.argsort(producer, kind="stable")].tolist()
    by = np.append(0, np.cumsum(np.bincount(producer, minlength=n))).tolist()
    pending = np.bincount(consumer, minlength=n).tolist()
    unread = [True] * n_in
    limit = n_in + n if cap is None else cap
    # The live count now, and the most of the stage before and of this one
    # so far: an input first read in stage s takes its column at the start
    # of stage s - 1, so it raises both.
    live = peak_before = peak = 0
    groups: list[list[int]] = []
    used = 0  # rows in the current stage
    ready: list[int] = []  # heap of the window's ready gates
    hi = 0  # the window: the unscheduled gates below hi, `window` of them
    open_gates = scheduled = 0
    while scheduled < n:
        group: list[int] = []
        held: list[int] = []
        first = net = 0  # the group's inputs first read, and values taken less freed
        room = min(GATE_GROUP, ROW_CHUNK - used)
        while len(group) < room:
            while open_gates < window and hi < n:
                if not pending[hi]:
                    heapq.heappush(ready, hi)
                hi, open_gates = hi + 1, open_gates + 1
            if not ready and (group or not held):
                break
            force = not ready  # nothing fits: the first held gate runs
            g = held.pop(0) if force else heapq.heappop(ready)
            k, f = 0, 1
            operands = reads[at[g]:at[g + 1]]
            for v, c in operands:
                if v < n_in and unread[v]:
                    k += 1
                if left[v] == c and not keep[v]:
                    f -= 1
            if not force and (peak_before + first + k > limit or peak + first + k > limit
                              or live + first + k + net + f > limit):
                held.append(g)
                continue
            group.append(g)
            open_gates -= 1
            first, net = first + k, net + f
            for v, c in operands:
                left[v] -= c
                if v < n_in:
                    unread[v] = False
            if held:  # reads completed: the held gates may fit now
                for h in held:
                    heapq.heappush(ready, h)
                held = []
        for g in held:
            heapq.heappush(ready, g)
        dead = sum(1 for g in group if not left[n_in + g] and not keep[n_in + g])
        peak_before += first
        peak = max(peak + first, live + first + net)
        live += first + net - dead
        limit = max(limit, peak_before, peak)
        groups.append(group)
        scheduled += len(group)
        used = (used + len(group)) % ROW_CHUNK
        if not used:
            peak_before, peak = peak, live
        for g in group:
            for c in consumers[by[g]:by[g + 1]]:
                pending[c] -= 1
                if not pending[c] and c < hi:
                    heapq.heappush(ready, c)
    return groups + [[-1]] * ((ROW_CHUNK - used) % ROW_CHUNK)


class LiveState(NamedTuple):
    """The loop kernel's own columns for the rows of :func:`loop_groups`
    (:func:`live_state`); ``state_cols`` is the zero column, ``state_cols +
    1`` the ones column."""

    operands: np.ndarray  # [n_rows, 3]: the state column each read field names
    out: np.ndarray  # [n_rows]: the state column each row writes
    state_cols: int
    staged: np.ndarray  # [n_staged, 3]: (stage, input index, state column)
    out_slots: np.ndarray  # [n_out]: each output's state column


def live_state(flow: Dataflow, groups: list[list[int]]) -> LiveState:
    """Allocate the loop kernel's state columns for the rows of ``groups``
    (:func:`loop_groups`), each a gate of ``flow`` or -1, a pad.

    Each value holds a state column from its start to its last read, or to
    the end if the schedule returns it; a linear scan over those intervals
    reaches the peak number of values live at once.  A group reads all its
    operands before it writes, so a value last read in a group frees its
    column for the values the group writes.  An input is staged in the
    stage of its first reader, and one that is returned unread in stage
    ``n_rows / ROW_CHUNK`` after the last; its copy lands while the stage
    before runs, so its column is held from the start of that stage.  The
    zero value, and a pad's write, is the zero column."""
    gate = np.array([g for grp in groups for g in grp], dtype=np.int64).reshape(-1)
    group = np.repeat(np.arange(len(groups)), [len(g) for g in groups])
    n_rows, n_in, zero_value = len(gate), flow.n_in, -1
    n_values = n_in + len(flow.ops)
    wrote = np.flatnonzero(gate >= 0)  # row wrote[i] writes value n_in + gate[wrote[i]]
    operands = np.full((n_rows, 3), zero_value)
    operands[wrote] = flow.reads[gate[wrote]]
    read_row, field = np.nonzero(operands != zero_value)
    read_value = operands[read_row, field]
    last = np.full(n_values, -1)
    np.maximum.at(last, read_value, group[read_row])
    first = np.full(n_in, n_rows)  # first reader's row
    inputs = read_value < n_in
    np.minimum.at(first, read_value[inputs], read_row[inputs])
    final = flow.outputs
    returned = np.zeros(n_values, bool)
    returned[final[final != zero_value]] = True

    # Times: the inputs staged in stage k + 1 take their columns at 4 * (the
    # first group of stage k), before any of its rows; group g's reads free
    # at 4g + 2 and its writes take at 4g + 3; a write never read frees at
    # 4g + 4.  At one time, frees come before takes.
    staged_in = np.flatnonzero((first < n_rows) | returned[:n_in])
    stage = first[staged_in] // ROW_CHUNK  # n_rows / ROW_CHUNK if returned unread
    first_group = np.append(group[::ROW_CHUNK], 0)  # of each stage; 0 with no rows
    take_in = 4 * first_group[np.maximum(stage - 1, 0)]
    take_gate = 4 * group[wrote] + 3
    values = np.concatenate([staged_in, n_in + gate[wrote]])
    take = np.concatenate([take_in, take_gate])
    free = np.where(last[values] >= 0, 4 * last[values] + 2, take + 1)
    freed = ~returned[values]
    order = np.argsort(np.concatenate([2 * take + 1, 2 * free[freed]]), kind="stable")
    who = np.concatenate([values, values[freed]])[order].tolist()
    taking = (order < len(values)).tolist()
    col = [0] * n_values
    spare: list[int] = []
    width = 0
    for t, v in zip(taking, who):
        if not t:
            spare.append(col[v])
        elif spare:
            col[v] = spare.pop()
        else:
            col[v], width = width, width + 1
    col = np.array(col + [width], dtype=np.int64)  # [-1], the zero value: the zero column
    out_value = np.full(n_rows, zero_value)
    out_value[wrote] = n_in + gate[wrote]
    return LiveState(col[operands], col[out_value], width,
                     np.stack([stage, staged_in, col[staged_in]], axis=1),
                     col[final])


class LoopTable(NamedTuple):
    """What the loop kernel reads beside the planes (:func:`pack_rows`).
    Stage ``s`` of the table's ``n_rows / ROW_CHUNK`` stages stages the
    inputs ``staged[stage_starts[s]:stage_starts[s + 1]]`` into their state
    columns; stage ``n_rows / ROW_CHUNK``, past the last, those returned
    unread."""

    rows: torch.Tensor  # int32 [n_rows, 2]: the packed gate table
    stage_starts: torch.Tensor  # int32 [n_rows / ROW_CHUNK + 2]
    staged: torch.Tensor  # int32 [n_staged, 2]: (input index, state column)
    out_slots: torch.Tensor  # int32 [n_out]: each output's state column
    state_cols: int  # the live state's width, beside the two constant columns
    words: int  # words a block: words_per_block(state_cols)
    groups: int  # the table's groups, the stage pads' included

    def to(self, device: torch.device) -> LoopTable:
        return self._replace(**{f: getattr(self, f).to(device).contiguous()
                                for f in ("rows", "stage_starts", "staged", "out_slots")})


def pack_rows(compiled: ir.CompiledSchedule) -> LoopTable:
    """The loop kernel's table: the rows of :func:`loop_groups` on the
    columns of :func:`live_state`, with the operands of
    :func:`loop_operands`, packed into 8 bytes each, and the staging lists
    and output columns of that state.

    The rows are list-scheduled by dataflow under a cap on the live state:
    the widest that keeps program order's words a block, and no wider than
    the columns the schedule names.  Should a window of
    ``SCHEDULE_WINDOW`` gates pass the cap all the same, a window a quarter
    as wide is tried, then one a sixteenth, then program order is kept, so
    the table never costs words a block.  Raises ``ValueError`` if program
    order's live state does not fit 12-bit columns or shared memory."""
    flow = dataflow(compiled)
    groups = loop_groups(flow, window=1)
    state = live_state(flow, groups)
    if state.state_cols > MAX_LOOP_COLS:
        raise ValueError(f"a {state.state_cols}-column live state and two constant "
                         f"columns do not fit the loop kernel's {COL_BITS}-bit column indices")
    words = words_per_block(state.state_cols)
    named = 1 + max(compiled.ops[:, 1:].max(initial=-1), *compiled.input_slots,
                    *compiled.output_slots, -1)
    cap = min((SMEM_LIMIT_BYTES - 2 * ROW_CHUNK * ROW_BYTES) // (4 * words) - 2,
              MAX_LOOP_COLS, max(named, state.state_cols))
    for window in (SCHEDULE_WINDOW, SCHEDULE_WINDOW // 4, SCHEDULE_WINDOW // 16):
        scheduled = loop_groups(flow, cap, window)
        by_dataflow = live_state(flow, scheduled)
        if by_dataflow.state_cols <= cap:
            groups, state = scheduled, by_dataflow
            break
    n = state.state_cols
    gate = np.array([g for grp in groups for g in grp], dtype=np.int64).reshape(-1)
    op = np.where(gate >= 0, flow.ops[gate], OP_INIT0)
    constants = np.broadcast_to(np.array([n, n + 1]), (len(gate), 2))
    choices = np.concatenate([state.operands, constants], axis=1)
    a, b, c = np.take_along_axis(choices, _OPERANDS[op], axis=1).T
    invert = _INVERT[op]
    size = np.zeros(len(gate), dtype=np.int64)
    sizes = np.array([len(g) for g in groups], dtype=np.int64)
    size[np.cumsum(sizes) - sizes] = sizes - 1
    table = np.stack([a | op << OP_SHIFT | invert << INVERT_SHIFT | b << HALF_SHIFT,
                      c | size << GROUP_SHIFT | state.out << HALF_SHIFT], axis=1)
    stage, staged = state.staged[:, 0], state.staged[:, 1:]
    order = np.argsort(stage, kind="stable")
    stage_starts = np.searchsorted(stage[order], np.arange(len(gate) // ROW_CHUNK + 2))
    return LoopTable(
        torch.from_numpy(table.astype(np.uint32).view(np.int32)),
        torch.from_numpy(stage_starts.astype(np.int32)),
        torch.from_numpy(staged[order].astype(np.int32)),
        torch.from_numpy(state.out_slots.astype(np.int32)), n, words_per_block(n),
        len(groups))


def loop_plain(compiled: ir.CompiledSchedule, planes: torch.Tensor) -> torch.Tensor:
    """Plain version of the loop kernel: the reference ``interpreter``'s
    per-gate walk over an int32 ``[num_cols, W]`` state."""
    return ir.interpret(compiled, planes)


@functools.lru_cache(maxsize=None)
def _loop_lib() -> ctypes.CDLL:
    with spans.span("exec.build", what="loop library"):
        _build.build(build_jobs())  # one nvcc round with the packing kernels
        lib = _build.load("bitserial_loop", LOOP_SOURCE.read_text())
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bitserial_loop_launch.argtypes = [p, p, p, p, p, p, i, i, i,
                                          ctypes.c_longlong, i, p]
    lib.bitserial_loop_launch.restype = ctypes.c_int
    lib.bitserial_error_string.argtypes = [ctypes.c_int]
    lib.bitserial_error_string.restype = ctypes.c_char_p
    return lib


def launch_loop(lib: ctypes.CDLL, table: LoopTable, planes: torch.Tensor,
                out: torch.Tensor) -> int:
    """Launch ``lib``'s loop kernel with ``table`` (on the planes' device)
    over ``planes`` into ``out`` on the current stream; returns the launch's
    CUDA error code."""
    return lib.bitserial_loop_launch(
        planes.data_ptr(), out.data_ptr(), table.rows.data_ptr(),
        table.stage_starts.data_ptr(), table.staged.data_ptr(), table.out_slots.data_ptr(),
        out.shape[0], table.rows.shape[0], table.state_cols, planes.shape[1], table.words,
        torch.cuda.current_stream(planes.device).cuda_stream)


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.bitserial_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")


def _launch_loop(key: str, planes: torch.Tensor) -> torch.Tensor:
    table = _loop_table(key, planes.device)
    lib = _loop_lib()
    out = torch.empty((table.out_slots.shape[0], planes.shape[1]), dtype=torch.int32,
                      device=planes.device)
    if planes.shape[1] == 0:
        return out
    with spans.span("exec.launch", state_cols=table.state_cols, words=table.words,
                    groups=table.groups):
        err = launch_loop(lib, table, planes, out)
    _check(lib, err, f"bitserial_loop launch for {key!r}")
    spans.count("exec.launches.bitserial_loop")
    return out


# ---------------------------------------------------------------------------
# Wave-scheduled straight-line kernel (the `unrolled` mode)
# ---------------------------------------------------------------------------


def _wave_chunks(rows):
    """Greedy hazard-free chunking of allocated schedule rows.

    A gate joins the current chunk while it reads no column written earlier
    in the chunk (and does not re-write one).  All reads of a chunk then see
    pre-chunk state, so read-then-write code — every result computed before
    any column is stored — is exactly program-order semantics, and each
    chunk is a batch of mutually independent ops.
    """
    chunks: list[list[tuple[int, int, int, int, int]]] = []
    cur: list[tuple[int, int, int, int, int]] = []
    written: set[int] = set()
    for row in rows:
        op, a, b, c, o = row
        reads = {(a, b, c)[s] for s in operand_slots(op)}
        if cur and (reads & written or o in written):
            chunks.append(cur)
            cur, written = [], set()
        cur.append(row)
        written.add(o)
    if cur:
        chunks.append(cur)
    return chunks


def _segments(compiled: ir.CompiledSchedule):
    """Wave chunks grouped into straight-line segments of at most
    ``UNROLL_SEGMENT_GATES`` gates (chunk boundaries are never split)."""
    rows = [tuple(int(x) for x in row) for row in compiled.ops]
    segments: list[list[list[tuple[int, int, int, int, int]]]] = [[]]
    count = 0
    for chunk in _wave_chunks(rows):
        if count and count + len(chunk) > UNROLL_SEGMENT_GATES:
            segments.append([])
            count = 0
        segments[-1].append(chunk)
        count += len(chunk)
    return segments


def _gate(op: int, va, vb, vc, zero):
    if op == OP_NOR:
        return ~(va | vb)
    if op == OP_MAJ3:
        return (va & vb) | (va & vc) | (vb & vc)
    if op == OP_NOT:
        return ~va
    if op == OP_INIT0:
        return zero
    if op == OP_INIT1:
        return ~zero
    return va  # OP_COPY


def unrolled_plain(compiled: ir.CompiledSchedule, planes: torch.Tensor,
                   segments=None) -> torch.Tensor:
    """Plain version of the straight-line kernel: a Python walk over a list
    of column tensors, segment by segment and chunk by chunk, each chunk
    computing all results from pre-chunk columns before assigning any."""
    segments = _segments(compiled) if segments is None else segments
    zero = torch.zeros(planes.shape[1], dtype=torch.int32, device=planes.device)
    cols = [zero] * compiled.num_cols
    for i, slot in enumerate(compiled.input_slots):
        cols[slot] = planes[i]
    for chunks in segments:
        for chunk in chunks:
            results = [(o, _gate(op, cols[a], cols[b], cols[c], zero))
                       for op, a, b, c, o in chunk]
            for o, r in results:
                cols[o] = r
    return torch.stack([cols[s] for s in compiled.output_slots])


def unrolled_source(key: str) -> str:
    return bitserial_codegen.generate(_SCHEDULES[key], _segment_cache(key))


def _unrolled_lib(key: str) -> ctypes.CDLL:
    built = _BUILT[key]
    if built.unrolled_lib is None:
        with spans.span("exec.build", what="unrolled library"):
            lib = _build.load("bitserial_unrolled", unrolled_source(key))
        p = ctypes.c_void_p
        lib.bitserial_segment_launch.argtypes = [ctypes.c_int, p, p, p,
                                                 ctypes.c_longlong, p]
        lib.bitserial_segment_launch.restype = ctypes.c_int
        lib.bitserial_error_string.argtypes = [ctypes.c_int]
        lib.bitserial_error_string.restype = ctypes.c_char_p
        built.unrolled_lib = lib
    return built.unrolled_lib


def _launch_unrolled(key: str, planes: torch.Tensor) -> torch.Tensor:
    compiled = _SCHEDULES[key]
    n_seg = len(_segment_cache(key))
    lib = _unrolled_lib(key)
    W = planes.shape[1]
    out = torch.empty((len(compiled.output_slots), W), dtype=torch.int32,
                      device=planes.device)
    if W == 0:
        return out
    # Segments thread the crossbar state through device memory; segment 0
    # writes every column a later segment reads, so it needs no zeroing.
    state = (torch.empty((compiled.num_cols, W), dtype=torch.int32,
                         device=planes.device) if n_seg > 1 else None)
    state_ptr = state.data_ptr() if state is not None else None
    stream = torch.cuda.current_stream(planes.device).cuda_stream
    with spans.span("exec.launch"):
        for seg in range(n_seg):
            err = lib.bitserial_segment_launch(seg, planes.data_ptr(), state_ptr,
                                               out.data_ptr(), W, stream)
            _check(lib, err, f"bitserial_unrolled segment {seg} launch for {key!r}")
            spans.count("exec.launches.bitserial_unrolled")
    return out


# ---------------------------------------------------------------------------
# Per-schedule caches and dispatch
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Built:
    """What the executor built for one registered schedule, each on first
    use: loop-kernel tables by device, the wave-chunked straight-line
    segments and their library."""

    tables: dict[torch.device, LoopTable] = dataclasses.field(default_factory=dict)
    segments: list | None = None
    unrolled_lib: ctypes.CDLL | None = None


# Registry of compiled schedules by key, and what was built for each;
# rebinding a key to another schedule replaces its record whole.
_SCHEDULES: dict[str, ir.CompiledSchedule] = {}
_BUILT: dict[str, _Built] = {}


def _check_columns(key: str, compiled: ir.CompiledSchedule) -> None:
    """Every column a schedule names must lie below ``num_cols``: neither
    kernel checks its indices."""
    cols = [*compiled.ops[:, 1:].reshape(-1).tolist(), *compiled.input_slots,
            *compiled.output_slots]
    if any(not 0 <= c < compiled.num_cols for c in cols):
        raise ValueError(f"schedule {key!r} indexes a column outside "
                         f"0..{compiled.num_cols - 1}")


def _loop_table(key: str, device: torch.device) -> LoopTable:
    """The loop kernel's :class:`LoopTable` on ``device``, built once per key
    and device."""
    tables = _BUILT[key].tables
    table = tables.get(device)
    if table is None:
        with spans.span("exec.build", what="table"):
            table = tables[device] = pack_rows(_SCHEDULES[key]).to(device)
    return table


def _segment_cache(key: str) -> list:
    built = _BUILT[key]
    if built.segments is None:
        with spans.span("exec.build", what="segments"):
            built.segments = _segments(_SCHEDULES[key])
    return built.segments


def register_compiled(compiled: ir.CompiledSchedule, key: str | None = None) -> str:
    key = key or compiled.key
    if _SCHEDULES.get(key) is not compiled:
        _check_columns(key, compiled)
        _SCHEDULES[key] = compiled
        _BUILT[key] = _Built()
    return key


def register_schedule(key: str, schedule: Schedule | ir.CompiledSchedule) -> None:
    """Register a schedule under ``key``.  Accepts a ``CompiledSchedule`` or a
    legacy (column-allocated) ``machine.Schedule``, which is wrapped as-is."""
    if not isinstance(schedule, ir.CompiledSchedule):
        schedule = ir.CompiledSchedule.from_legacy(schedule, key=key)
    register_compiled(schedule, key)


def build_jobs(keys=()) -> list[tuple[str, str]]:
    """``(name, source)`` build jobs of the loop kernel, of the packing
    kernels (``pim_bitplanes``, which every call on the card runs) and of
    the straight-line kernels of the registered schedules ``keys``, for
    ``_build.build`` to compile all at once."""
    jobs = [("bitserial_loop", LOOP_SOURCE.read_text()), pim_bitplanes.build_job()]
    jobs += [("bitserial_unrolled", unrolled_source(k)) for k in keys]
    return jobs


def resolve_mode(compiled: ir.CompiledSchedule, mode: str = "auto") -> str:
    """``auto`` picks by gate count; ``unrolled``/``loop`` force a kernel."""
    if mode == "auto":
        return ("unrolled" if compiled.num_gates <= UNROLL_AUTO_MAX_GATES
                else "loop")
    if mode not in ("unrolled", "loop"):
        raise ValueError(f"unknown executor mode {mode!r} "
                         "(expected 'auto', 'unrolled' or 'loop')")
    return mode


def run_schedule(key: str, planes: torch.Tensor, mode: str = "auto") -> torch.Tensor:
    """Execute registered schedule ``key`` over stacked input planes.

    planes: ``[n_inputs, W]`` int32 — inputs concatenated in sorted-name
    order (matching ``CompiledSchedule.input_slots``).  Returns
    ``[n_outputs, W]``.  W is padded to a BLOCK_WORDS multiple internally.
    A CUDA tensor runs the selected kernel; a CPU tensor runs its plain
    version.
    """
    compiled = _SCHEDULES[key]
    if planes.dim() != 2 or planes.shape[0] != len(compiled.input_slots):
        expected = {name: len(cols)
                    for name, cols in sorted(compiled.input_cols.items())}
        raise ValueError(
            f"schedule {key!r} expects {len(compiled.input_slots)} stacked "
            f"input planes ({expected}, in sorted-name order), got "
            f"{tuple(planes.shape)}")
    if planes.dtype != torch.int32:
        raise TypeError(f"planes must be int32, got {planes.dtype}")
    mode = resolve_mode(compiled, mode)
    W = planes.shape[1]
    pad = (-W) % BLOCK_WORDS
    if pad:
        planes = torch.nn.functional.pad(planes, (0, pad))
    planes = planes.contiguous()
    if planes.device.type == "cuda":
        launch = _launch_unrolled if mode == "unrolled" else _launch_loop
        out = launch(key, planes)
    elif planes.device.type == "cpu":
        out = (unrolled_plain(compiled, planes, _segment_cache(key))
               if mode == "unrolled" else loop_plain(compiled, planes))
    else:
        raise ValueError(f"no executor for device {planes.device}")
    return out[:, :W]


class CudaBackend(ir.Backend):
    """GPU executor, kernel chosen by gate count; ``opts['mode']`` overrides
    the selection per call.  CPU planes run the kernels' plain versions."""

    name = "cuda"
    mode = "auto"

    def run(self, compiled, planes=None, mode: str | None = None, **opts):
        if planes is None:
            raise ValueError(f"{self.name} backend needs input planes")
        with spans.span("exec.run_schedule"):
            key = register_compiled(compiled)
            out = run_schedule(key, planes, mode=mode or self.mode)
        return ir.ExecutionResult(out, compiled.report)


class CudaUnrolledBackend(CudaBackend):
    """Forces the straight-line kernel regardless of size."""

    name = "cuda-unrolled"
    mode = "unrolled"


class CudaLoopBackend(CudaBackend):
    """Forces the loop kernel."""

    name = "cuda-loop"
    mode = "loop"


ir.register_backend(CudaBackend())
ir.register_backend(CudaUnrolledBackend())
ir.register_backend(CudaLoopBackend())
