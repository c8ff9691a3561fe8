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
  and walks a packed gate table (:func:`pack_rows`: 8 bytes a row, rows in
  hazard-free groups of ``GATE_GROUP`` so each group reads all its operands
  before it writes).  Any schedule, no per-schedule build.
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
import functools
from pathlib import Path

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

from . import _build, bitserial_codegen

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
# opcode does not read names one of two constant columns after the
# schedule's own: all zeros (``num_cols``) and all ones (``num_cols + 1``).
OP_SHIFT = 12
INVERT_SHIFT = 15
GROUP_SHIFT = 12
HALF_SHIFT = 16
MAX_LOOP_COLS = (1 << COL_BITS) - 2  # and the two constant columns

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


def words_per_block(num_cols: int) -> int:
    """Packed words per block of the loop kernel: the largest multiple of 32
    (at most 1024 threads) whose ``[num_cols + 2, words]`` state (with the
    two constant columns) fits in shared memory beside the two gate-table
    stages."""
    room = SMEM_LIMIT_BYTES - 2 * ROW_CHUNK * ROW_BYTES
    words = min(1024 * LOOP_WORDS_PER_THREAD,
                room // (4 * (max(num_cols, 1) + 2)) // 32 * 32)
    if words < 32:
        raise ValueError(
            f"a {num_cols}-column schedule does not fit the loop kernel's "
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


def loop_groups(compiled: ir.CompiledSchedule) -> list[list[tuple[int, int, int, int, int]]]:
    """The loop kernel's row order: the schedule's rows in program order,
    each hazard-free wave chunk cut into groups of at most ``GATE_GROUP``.
    A group never straddles a ``ROW_CHUNK`` stage: the stage's tail, and the
    table's, is filled with one-row groups that write zero into the zero
    column ``num_cols``.  A group read in full before it is written computes
    what program order computes."""
    pad = [(OP_INIT0, 0, 0, 0, compiled.num_cols)]
    groups: list[list[tuple[int, int, int, int, int]]] = []
    used = 0  # rows in the current stage
    rows = [tuple(int(x) for x in row) for row in compiled.ops]
    for chunk in _wave_chunks(rows):
        for i in range(0, len(chunk), GATE_GROUP):
            group = chunk[i:i + GATE_GROUP]
            if used + len(group) > ROW_CHUNK:
                groups += [pad] * (ROW_CHUNK - used)
                used = 0
            groups.append(group)
            used = (used + len(group)) % ROW_CHUNK
    groups += [pad] * ((ROW_CHUNK - used) % ROW_CHUNK)
    return groups


def pack_rows(compiled: ir.CompiledSchedule) -> torch.Tensor:
    """The loop kernel's gate table: the rows of :func:`loop_groups` with
    the operands of :func:`loop_operands`, packed into 8 bytes each,
    ``int32 [rows, 2]``.  Raises ``ValueError`` if a column index does not
    fit 12 bits or the state does not fit shared memory."""
    n = compiled.num_cols
    if n > MAX_LOOP_COLS:
        raise ValueError(f"a {n}-column schedule and two constant columns do not "
                         f"fit the loop kernel's {COL_BITS}-bit column indices")
    words_per_block(n)
    table = []
    for group in loop_groups(compiled):
        for i, (op, a, b, c, o) in enumerate(group):
            a, b, c, invert = loop_operands(op, a, b, c, n)
            size = len(group) - 1 if i == 0 else 0
            table.append((a | op << OP_SHIFT | invert << INVERT_SHIFT | b << HALF_SHIFT,
                          c | size << GROUP_SHIFT | o << HALF_SHIFT))
    return torch.from_numpy(np.array(table, dtype=np.uint32).reshape(-1, 2).view(np.int32))


def loop_plain(compiled: ir.CompiledSchedule, planes: torch.Tensor) -> torch.Tensor:
    """Plain version of the loop kernel: the reference ``interpreter``'s
    per-gate walk over an int32 ``[num_cols, W]`` state."""
    return ir.interpret(compiled, planes)


@functools.lru_cache(maxsize=None)
def _loop_lib() -> ctypes.CDLL:
    with spans.span("exec.build", what="loop library"):
        lib = _build.load("bitserial_loop", LOOP_SOURCE.read_text())
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bitserial_loop_launch.argtypes = [p, p, p, p, p, i, i, i, i,
                                          ctypes.c_longlong, i, p]
    lib.bitserial_loop_launch.restype = ctypes.c_int
    lib.bitserial_error_string.argtypes = [ctypes.c_int]
    lib.bitserial_error_string.restype = ctypes.c_char_p
    return lib


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.bitserial_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")


def _launch_loop(key: str, planes: torch.Tensor) -> torch.Tensor:
    compiled = _SCHEDULES[key]
    table, in_slots, out_slots = _loop_table(key, planes.device)
    lib = _loop_lib()
    n_in, W = planes.shape
    out = torch.empty((out_slots.shape[0], W), dtype=torch.int32,
                      device=planes.device)
    if W == 0:
        return out
    stream = torch.cuda.current_stream(planes.device).cuda_stream
    words = words_per_block(compiled.num_cols)
    with spans.span("exec.launch"):
        err = lib.bitserial_loop_launch(
            planes.data_ptr(), out.data_ptr(), table.data_ptr(),
            in_slots.data_ptr(), out_slots.data_ptr(), n_in, out.shape[0],
            table.shape[0], compiled.num_cols, W, words, stream)
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
    lib = _UNROLLED_LIBS.get(key)
    if lib is None:
        with spans.span("exec.build", what="unrolled library"):
            lib = _build.load("bitserial_unrolled", unrolled_source(key))
        p = ctypes.c_void_p
        lib.bitserial_segment_launch.argtypes = [ctypes.c_int, p, p, p,
                                                 ctypes.c_longlong, p]
        lib.bitserial_segment_launch.restype = ctypes.c_int
        lib.bitserial_error_string.argtypes = [ctypes.c_int]
        lib.bitserial_error_string.restype = ctypes.c_char_p
        _UNROLLED_LIBS[key] = lib
    return lib


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

# Registry of compiled schedules by key.
_SCHEDULES: dict[str, ir.CompiledSchedule] = {}
# Loop-kernel packed gate tables uploaded once per (key, device).
_LOOP_TABLES: dict[str, dict[torch.device, tuple]] = {}
# Wave-chunked straight-line segments and their built libraries.
_SEGMENTS: dict[str, list] = {}
_UNROLLED_LIBS: dict[str, ctypes.CDLL] = {}
# Bumped when a key is rebound to different schedule content, which drops
# every per-key artifact above.
_GENERATIONS: dict[str, int] = {}


def _invalidate(key: str) -> None:
    _LOOP_TABLES.pop(key, None)
    _SEGMENTS.pop(key, None)
    _UNROLLED_LIBS.pop(key, None)
    _GENERATIONS[key] = _GENERATIONS.get(key, 0) + 1


def _check_columns(key: str, compiled: ir.CompiledSchedule) -> None:
    """Every column a schedule names must lie below ``num_cols``: neither
    kernel checks its indices."""
    cols = [*compiled.ops[:, 1:].reshape(-1).tolist(), *compiled.input_slots,
            *compiled.output_slots]
    if any(not 0 <= c < compiled.num_cols for c in cols):
        raise ValueError(f"schedule {key!r} indexes a column outside "
                         f"0..{compiled.num_cols - 1}")


def _loop_table(key: str, device: torch.device) -> tuple:
    """``(packed gate table [rows, 2], input slots, output slots)`` int32 on
    ``device``, built once per key and device."""
    per_device = _LOOP_TABLES.setdefault(key, {})
    table = per_device.get(device)
    if table is None:
        with spans.span("exec.build", what="table"):
            compiled = _SCHEDULES[key]
            slots = (torch.tensor(x, dtype=torch.int32)
                     for x in (compiled.input_slots, compiled.output_slots))
            table = per_device[device] = tuple(
                x.to(device).contiguous() for x in (pack_rows(compiled), *slots))
    return table


def _segment_cache(key: str) -> list:
    segments = _SEGMENTS.get(key)
    if segments is None:
        with spans.span("exec.build", what="segments"):
            segments = _SEGMENTS[key] = _segments(_SCHEDULES[key])
    return segments


def register_compiled(compiled: ir.CompiledSchedule, key: str | None = None) -> str:
    key = key or compiled.key
    if _SCHEDULES.get(key) is not compiled:
        _check_columns(key, compiled)
        _invalidate(key)
    _SCHEDULES[key] = compiled
    return key


def register_schedule(key: str, schedule: Schedule | ir.CompiledSchedule) -> None:
    """Register a schedule under ``key``.  Accepts a ``CompiledSchedule`` or a
    legacy (column-allocated) ``machine.Schedule``, which is wrapped as-is."""
    if isinstance(schedule, ir.CompiledSchedule):
        register_compiled(schedule, key)
        return
    compiled = ir.CompiledSchedule.from_legacy(schedule, key=key)
    _check_columns(key, compiled)
    _invalidate(key)
    _SCHEDULES[key] = compiled


def build_jobs(keys=()) -> list[tuple[str, str]]:
    """``(name, source)`` build jobs of the loop kernel and of the
    straight-line kernels of the registered schedules ``keys``, for
    ``_build.build`` to compile all at once."""
    jobs = [("bitserial_loop", LOOP_SOURCE.read_text())]
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
            return ir.ExecutionResult(out, self.cost(compiled))


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
