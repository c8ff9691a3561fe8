"""The loop kernel's host-side table on the CPU: the packed rows, read
through the executor's live-state columns, are the compiled schedule's rows
on the same values, list-scheduled by dataflow into fewer groups than
program order gives; a plain PyTorch walk of the table in the kernel's
order (each group read in full before any of it is written, each stage's
inputs written when their copy is issued, at the start of the stage
before) equals the port's ``ir.interpret`` and the JAX reference
``interpreter`` word for word; staged inputs land in columns no row touches
meanwhile; the live state is no wider than the schedule, costs no words a
block against program order, and its width and group count are pinned for
the f32 MAC and the nine-tap conv row; and schedules whose live state the
kernel cannot take are refused.  The table format is also held against the
constants of ``csrc/bitserial_loop.cu``."""

import collections
import dataclasses
import functools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_ref import MAC, OP_CASES, schedule_fields

import repro.pim as ref_pim
from repro.core import ir as ref_ir
from repro_torch import convert
from repro_torch.core import ir
from repro_torch.core.machine import OP_INIT0, OP_INIT1, operand_slots
from repro_torch.kernels import pim_bitserial as pb

W = 45  # packed words
BASES = ("memristive", "dram")
PROGRAMS = {
    "f32_mac": lambda pim, basis: pim.compile(MAC, dtype=pim.f32).compiled(basis),
    "bf16_mac": lambda pim, basis: pim.compile(MAC, dtype=pim.bf16).compiled(basis),
    "int8_mac": lambda pim, basis: pim.compile(MAC, dtype=pim.int8).compiled(basis),
    "int16_mac": lambda pim, basis: pim.compile(MAC, dtype=pim.int16).compiled(basis),
    "fixed_add": lambda pim, basis: (
        pim.compile(lambda a, b: a + b, dtype=pim.fixed(32)).compiled(basis)),
}
CASES = [(name, basis) for name in PROGRAMS for basis in BASES]
# The nine-tap conv row of ``repro_torch.pim.conv`` (19 float32 arguments),
# about 20 s a basis to compile on the CPU: compiled once a basis in this file.
NINE_TAP_CASES = [("nine_tap", basis) for basis in BASES]
MASK = (1 << pb.COL_BITS) - 1


@functools.lru_cache(maxsize=None)
def _port(name: str, basis: str) -> ir.CompiledSchedule:
    if name == "nine_tap":
        from repro_torch.pim import conv

        return conv.PROGRAM.compiled(basis)
    import repro_torch.pim as pim

    return PROGRAMS[name](pim, basis)


def _ref(name: str, basis: str):
    """The JAX reference's schedule: compiled by the reference, but for the
    nine-tap row, whose port schedule is handed to the reference as it is."""
    if name == "nine_tap":
        return ref_ir.CompiledSchedule(**schedule_fields(_port(name, basis)))
    return PROGRAMS[name](ref_pim, basis)


@functools.lru_cache(maxsize=None)
def _table(name: str, basis: str) -> pb.LoopTable:
    return pb.pack_rows(_port(name, basis))


def _planes(n_in: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, (n_in, W), dtype=np.uint64).astype(np.uint32)


def _decode(rows: torch.Tensor) -> list[tuple[int, ...]]:
    """``(op, a, b, c, o, invert, group size or 0)`` per packed row, the
    operands as the kernel reads them (constant columns included)."""
    words = rows.numpy().view(np.uint32).astype(np.int64)
    half = pb.HALF_SHIFT
    return [(int(lo >> pb.OP_SHIFT) & 7, int(lo) & MASK, int(lo >> half) & MASK,
             int(hi) & MASK, int(hi >> half) & MASK, int(lo >> pb.INVERT_SHIFT) & 1,
             int(hi >> pb.GROUP_SHIFT) & 3)
            for lo, hi in words]


def _groups(rows):
    """The table's rows cut into groups by the size on each group's first
    row."""
    out, r = [], 0
    while r < len(rows):
        n = rows[r][6] + 1
        out.append((r, rows[r:r + n]))
        r += n
    return out


def _stage_lists(table: pb.LoopTable) -> list[list[tuple[int, int]]]:
    """``(input index, state column)`` pairs of each stage, the last one past
    the table's stages."""
    starts, staged = table.stage_starts.tolist(), [tuple(p) for p in table.staged.tolist()]
    assert len(starts) == table.rows.shape[0] // pb.ROW_CHUNK + 2 and starts[0] == 0
    assert starts[-1] == len(staged) and starts == sorted(starts)
    return [staged[a:b] for a, b in zip(starts, starts[1:])]


def _run(table: pb.LoopTable, state: list, inputs, gate):
    """The kernel's order over ``state`` (``state_cols + 2`` entries, the
    constant columns last): stage 0's inputs first, and each later stage's
    written when its copy is issued, at the start of the stage before; per
    group, every operand of every row, then ``gate`` into every output
    column.  Returns the state's entries at ``out_slots``."""
    stages = _stage_lists(table)

    def stage(s):
        for i, col in stages[s]:
            state[col] = inputs[i]
    stage(0)
    for start, group in _groups(_decode(table.rows)):
        if start % pb.ROW_CHUNK == 0:
            stage(start // pb.ROW_CHUNK + 1)
        results = [(row[4], gate(row, state[row[1]], state[row[2]], state[row[3]]))
                   for row in group]
        for o, value in results:
            state[o] = value
    return [state[s] for s in table.out_slots.tolist()]


def _walk(table: pb.LoopTable, planes: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: a state of ``state_cols``
    columns of junk, since every column is written before it is read, then
    the zero and ones columns; MAJ3 ^ invert a row."""
    words = planes.shape[1]
    zeros = torch.zeros(words, dtype=torch.int32)
    junk = torch.Generator().manual_seed(table.state_cols)
    state = [torch.randint(-2**31, 2**31, (words,), dtype=torch.int32, generator=junk)
             for _ in range(table.state_cols)] + [zeros, ~zeros]

    def gate(row, va, vb, vc):
        return ((va & vb) | (vc & (va | vb))) ^ (~zeros if row[5] else zeros)
    return torch.stack(_run(table, state, planes, gate))


class _Labels(dict):
    """Interned value labels: an input ``("in", i)``, the constants
    ``("zero",)`` and ``("ones",)``, and a gate's write ``(op, operand
    labels)``, the expression it computes, each numbered once."""

    def __missing__(self, key):
        self[key] = len(self)
        return self[key]


def _values(table: pb.LoopTable, n_in: int, labels: _Labels):
    """The table's rows as values: per real row (one that does not pad),
    ``(op, operand labels)``; then the outputs' labels.  A read of a column
    never written reads ``None``."""
    zero = table.state_cols
    state = [None] * zero + [labels["zero",], labels["ones",]]
    real = []

    def gate(row, *operands):
        op, o = row[0], row[4]
        if o == zero:  # padding: writes zero into the zero column
            assert row[:4] + row[5:6] == (OP_INIT0, zero, zero, zero, 0)
            return state[zero]
        real.append((op, tuple(operands[f] for f in operand_slots(op))))
        return labels[real[-1]]
    outs = _run(table, state, [labels["in", i] for i in range(n_in)], gate)
    return real, outs


def _schedule_values(compiled, labels: _Labels):
    """The same for the schedule's rows in program order: every column but
    the inputs starts as the zero value."""
    state = [labels["zero",]] * compiled.num_cols
    for i, slot in enumerate(compiled.input_slots):
        state[slot] = labels["in", i]
    real = []
    for op, *fields, o in compiled.ops.tolist():
        real.append((op, tuple(state[fields[f]] for f in operand_slots(op))))
        state[o] = labels[real[-1]]
    return real, [state[s] for s in compiled.output_slots]


def _program_order(compiled) -> list[list[int]]:
    """The table's groups in program order, as gate indices: each
    hazard-free wave chunk of the schedule cut into groups of at most
    ``GATE_GROUP``, and a stage's tail padded (``[-1]``) where a group would
    straddle it."""
    groups, used, start = [], 0, 0
    for chunk in pb._wave_chunks([tuple(int(x) for x in r) for r in compiled.ops]):
        for i in range(0, len(chunk), pb.GATE_GROUP):
            group = list(range(start + i, start + min(i + pb.GATE_GROUP, len(chunk))))
            if used + len(group) > pb.ROW_CHUNK:
                groups += [[-1]] * (pb.ROW_CHUNK - used)
                used = 0
            groups.append(group)
            used = (used + len(group)) % pb.ROW_CHUNK
        start += len(chunk)
    return groups + [[-1]] * ((pb.ROW_CHUNK - used) % pb.ROW_CHUNK)


def _real_groups(groups) -> int:
    return sum(1 for g in groups if g != [-1])


@pytest.mark.parametrize("name,basis", CASES + NINE_TAP_CASES)
def test_packed_rows_unpack_to_the_schedule(name, basis):
    compiled, table = _port(name, basis), _table(name, basis)
    assert table.rows.dtype == torch.int32 and table.rows.shape[1] == 2
    assert table.rows.shape[0] % pb.ROW_CHUNK == 0
    rows = _decode(table.rows)
    zero = table.state_cols
    for op, a, b, c, o, invert, _ in rows:
        # The kernel's operands and inversion are those of loop_operands.
        fields = [v if f in operand_slots(op) else 0 for f, v in enumerate((a, b, c))]
        assert pb.loop_operands(op, *fields, zero) == (a, b, c, bool(invert))
    # Read through the live state, each group reading all its operands
    # before it writes, the real rows are a permutation of the schedule's
    # rows on the same values, and the outputs are the same values: so each
    # group reads only values written in earlier groups.
    labels = _Labels()
    real, outs = _values(table, len(compiled.input_slots), labels)
    want, want_outs = _schedule_values(compiled, labels)
    assert len(real) == len(want) and collections.Counter(real) == collections.Counter(want)
    assert outs == want_outs
    groups = _groups(rows)
    assert sum(len(g) for _, g in groups) == len(rows) and len(groups) == table.groups
    for start, group in groups:
        assert 1 <= len(group) <= pb.GATE_GROUP
        assert start // pb.ROW_CHUNK == (start + len(group) - 1) // pb.ROW_CHUNK
        assert all(r[6] == 0 for r in group[1:])
        outs = [r[4] for r in group if r[4] != zero]
        assert len(set(outs)) == len(outs)  # no column written twice in a group
    # No more groups than program order's (pads aside, and with them).
    program = _program_order(compiled)
    n_real = sum(1 for _, g in groups if g[0][4] != zero)
    assert n_real <= _real_groups(program) and table.groups <= len(program)


@pytest.mark.parametrize("name,basis", CASES + NINE_TAP_CASES)
def test_table_walk_matches_interpreters(name, basis):
    compiled = _port(name, basis)
    planes = _planes(len(compiled.input_slots), len(name) + len(basis))
    tp = convert.planes_from_numpy(planes, device="cpu")
    got = _walk(_table(name, basis), tp)
    assert torch.equal(got, ir.interpret(compiled, tp))
    want = np.asarray(ref_ir.get_backend("interpreter").run(
        _ref(name, basis), jnp.asarray(planes)).planes)
    np.testing.assert_array_equal(convert.planes_to_numpy(got), want)


def _first_readers(compiled, table) -> dict[int, int]:
    """Each input's first reader, by table row."""
    first = {}
    labels = _Labels()
    inputs = {labels["in", i]: i for i in range(len(compiled.input_slots))}
    real, _ = _values(table, len(compiled.input_slots), labels)
    rows = [r for r, row in enumerate(_decode(table.rows)) if row[4] != table.state_cols]
    for r, (_, operands) in zip(rows, real):
        for v in operands:
            if v in inputs:
                first.setdefault(inputs[v], r)
    return first


@pytest.mark.parametrize("name,basis", CASES + NINE_TAP_CASES)
def test_staged_inputs_land_in_idle_columns(name, basis):
    """Every input a row reads is staged once, in the stage of its first
    reader, into a column that no row touches from the start of the stage
    before up to that reader's group; an input returned unread is staged
    past the last stage, and one neither read nor returned not at all."""
    compiled, table = _port(name, basis), _table(name, basis)
    first = _first_readers(compiled, table)
    stages = _stage_lists(table)
    staged = {i: (s, col) for s, pairs in enumerate(stages) for i, col in pairs}
    assert len(staged) == sum(len(p) for p in stages)  # each input once
    labels = _Labels()
    inputs = {labels["in", i]: i for i in range(len(compiled.input_slots))}
    _, outs = _schedule_values(compiled, labels)
    returned = {inputs[v] for v in outs if v in inputs}
    assert set(staged) == set(first) | returned
    rows = _decode(table.rows)
    group_start = {r: start for start, g in _groups(rows) for r in range(start, start + len(g))}
    n_stages = len(rows) // pb.ROW_CHUNK
    for i, (s, col) in staged.items():
        assert col < table.state_cols
        if i not in first:
            assert s == n_stages
            continue
        assert s == first[i] // pb.ROW_CHUNK
        held = rows[max(s - 1, 0) * pb.ROW_CHUNK:group_start[first[i]]]
        assert all(col not in row[1:5] for row in held), (i, s, col)
        assert col in rows[first[i]][1:4]


@pytest.mark.parametrize("op,nbits", OP_CASES)
@pytest.mark.parametrize("basis", BASES)
def test_live_state_is_no_wider_than_the_schedule(op, nbits, basis):
    compiled = ir.compile_op(op, nbits, basis=basis)
    table = pb.pack_rows(compiled)
    assert table.state_cols <= compiled.num_cols
    assert table.words == pb.words_per_block(table.state_cols)


@pytest.mark.parametrize("op,nbits", OP_CASES)
@pytest.mark.parametrize("basis", BASES)
def test_dataflow_order_never_costs_words(op, nbits, basis):
    """Against program order's table on the same schedule, the dataflow
    order gives no fewer words a block and no more groups."""
    compiled = ir.compile_op(op, nbits, basis=basis)
    table = pb.pack_rows(compiled)
    program = _program_order(compiled)
    width = pb.live_state(pb.dataflow(compiled), program).state_cols
    assert table.words >= pb.words_per_block(width)
    assert table.groups <= len(program)


# (state_cols, words a block, groups with the stage pads) by program and
# basis.  Program order gave 127 / 121 / 191 / 185 columns at the same
# words a block, and 6642 / 4131 / 59744 / 37007 groups without the pads.
PINNED = {("nine_tap", "memristive"): (191, 288, 30297),
          ("nine_tap", "dram"): (186, 288, 20478),
          ("f32_mac", "memristive"): (127, 416, 3445),
          ("f32_mac", "dram"): (122, 448, 2262)}
PROGRAM_ORDER_GROUPS = {("nine_tap", "memristive"): 59744, ("nine_tap", "dram"): 37007,
                        ("f32_mac", "memristive"): 6642, ("f32_mac", "dram"): 4131}


@pytest.mark.parametrize("name,basis", PINNED)
def test_live_state_widths_are_pinned(name, basis):
    table, compiled = _table(name, basis), _port(name, basis)
    assert (table.state_cols, table.words, table.groups) == PINNED[name, basis]
    assert table.state_cols <= compiled.num_cols
    assert _real_groups(_program_order(compiled)) == PROGRAM_ORDER_GROUPS[name, basis]
    n_real = sum(1 for _, g in _groups(_decode(table.rows)) if g[0][4] != table.state_cols)
    assert n_real <= 0.56 * PROGRAM_ORDER_GROUPS[name, basis]


@pytest.mark.parametrize("n_gates", [0, 3])
def test_short_schedule_tables(n_gates):
    """A schedule with no gates has an empty table (the kernel then fetches
    no stage) and stages what it returns before the loop; three gates fill
    one padded stage.  Either walks to what ``ir.interpret`` gives."""
    full = ir.compile_op("fixed_add", 8)
    compiled = dataclasses.replace(full, key=f"fixed_add8_first{n_gates}",
                                   ops=full.ops[:n_gates])
    table = pb.pack_rows(compiled)
    assert table.rows.shape == (pb.ROW_CHUNK if n_gates else 0, 2)
    assert table.stage_starts.shape == (table.rows.shape[0] // pb.ROW_CHUNK + 2,)
    planes = convert.planes_from_numpy(_planes(len(compiled.input_slots), n_gates),
                                       device="cpu")
    assert torch.equal(_walk(table, planes), ir.interpret(compiled, planes))


def test_unread_and_unwritten_columns():
    """An input nobody reads or returns is not staged; one returned unread
    is staged past the last stage; an output column the schedule never
    writes reads the zero column."""
    fields = schedule_fields(ir.compile_op("fixed_add", 8))
    n = fields["num_cols"]
    ops = [(OP_INIT1, 0, 0, 0, n - 1)] * 300  # two stages of one dead column
    compiled = convert.compiled_from_numpy(dict(
        fields, ops=ops, input_cols={"a": [0], "b": [1], "c": [2]},
        output_cols={"b": [1], "never": [3], "ones": [n - 1]}))
    table = pb.pack_rows(compiled)
    stages = _stage_lists(table)
    assert [len(p) for p in stages] == [0, 0, 1] and stages[-1][0][0] == 1
    assert table.out_slots[1] == table.state_cols  # the zero column
    planes = convert.planes_from_numpy(_planes(3, 11), device="cpu")
    assert torch.equal(_walk(table, planes), ir.interpret(compiled, planes))


def _outputs_only(n_cols: int) -> ir.CompiledSchedule:
    """A schedule that writes ``n_cols`` columns and returns them all, so all
    are live at its end."""
    fields = schedule_fields(ir.compile_op("fixed_add", 8))
    return convert.compiled_from_numpy(dict(
        fields, num_cols=n_cols, ops=[(OP_INIT1, 0, 0, 0, c) for c in range(n_cols)],
        input_cols={"a": [0]}, output_cols={"out": list(range(n_cols))}))


def test_loop_table_refuses_what_the_kernel_cannot_take():
    """The kernel's limits hold for the live state: a schedule of many
    columns whose live set is narrow fits; one whose live set does not fit
    12 bits, or shared memory beside the row stages, is refused."""
    fields = schedule_fields(ir.compile_op("fixed_add", 8))
    narrow = convert.compiled_from_numpy(dict(fields, num_cols=pb.MAX_LOOP_COLS + 1))
    assert pb.pack_rows(narrow).state_cols < 20
    with pytest.raises(ValueError, match="12-bit"):
        pb.pack_rows(_outputs_only(pb.MAX_LOOP_COLS + 1))
    # 2000 live columns fit 12 bits, but not shared memory.
    with pytest.raises(ValueError, match="shared memory"):
        pb.pack_rows(_outputs_only(2000))
    fits = pb.pack_rows(_outputs_only(1700))
    assert (fits.state_cols, fits.words) == (1700, 32)
    assert fits.rows.shape[0] == 7 * pb.ROW_CHUNK


def test_table_format_matches_the_kernel_source():
    src = pb.LOOP_SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("GROUP") == pb.GATE_GROUP
    assert const("ROW_CHUNK") == pb.ROW_CHUNK
    assert const("HALF_SHIFT") == pb.HALF_SHIFT
    assert const("INVERT_BIT") == pb.INVERT_SHIFT
    assert const("GROUP_SHIFT") == pb.GROUP_SHIFT
    assert const("WPT") == pb.LOOP_WORDS_PER_THREAD
    assert re.search(r"COL_MASK = 0x(\w+)u", src).group(1).lower() == f"{MASK:x}"
    # The launch takes the table's arrays in the order pim_bitserial binds.
    launch = re.search(r'extern "C" int bitserial_loop_launch\((.*?)\)', src, re.S).group(1)
    params = [p.split()[-1].lstrip("*") for p in launch.split(",")]
    assert params == ["planes_in", "planes_out", "table", "stage_starts", "staged",
                      "out_slots", "n_out", "n_rows", "state_cols", "W",
                      "words_per_block", "stream"]
    assert len(params) == 12
