"""The loop kernel's host-side gate table on the CPU: the packed rows unpack
to the compiled schedule exactly; a plain PyTorch walk of the table in the
kernel's order (each hazard-free group read in full before any of it is
written) equals the port's ``ir.interpret`` and the JAX reference
``interpreter`` word for word; and schedules the kernel cannot take are
refused.  The table format is also held against the constants of
``csrc/bitserial_loop.cu``."""

import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_ref import MAC, schedule_fields

import repro.pim as ref_pim
from repro.core import ir as ref_ir
from repro_torch import convert
from repro_torch.core import ir
from repro_torch.core.machine import operand_slots
from repro_torch.kernels import pim_bitserial as pb

W = 45  # packed words
PROGRAMS = {
    "f32_mac": lambda pim, basis: pim.compile(MAC, dtype=pim.f32).compiled(basis),
    "bf16_mac": lambda pim, basis: pim.compile(MAC, dtype=pim.bf16).compiled(basis),
    "int8_mac": lambda pim, basis: pim.compile(MAC, dtype=pim.int8).compiled(basis),
    "int16_mac": lambda pim, basis: pim.compile(MAC, dtype=pim.int16).compiled(basis),
    "fixed_add": lambda pim, basis: (
        pim.compile(lambda a, b: a + b, dtype=pim.fixed(32)).compiled(basis)),
}
CASES = [(name, basis) for name in PROGRAMS for basis in ("memristive", "dram")]
MASK = (1 << pb.COL_BITS) - 1


def _port(name: str, basis: str) -> ir.CompiledSchedule:
    import repro_torch.pim as pim

    return PROGRAMS[name](pim, basis)


def _decode(table: torch.Tensor) -> list[tuple[int, ...]]:
    """``(op, a, b, c, o, invert, group size or 0)`` per packed row, the
    operands as the kernel reads them (constant columns included)."""
    words = table.numpy().view(np.uint32).astype(np.int64)
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


def _walk(table: torch.Tensor, compiled, planes: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: a state with the zero and
    ones columns after the schedule's; per group, every operand of every
    row, then MAJ3 ^ invert into every output column."""
    words = planes.shape[1]
    zeros = torch.zeros(words, dtype=torch.int32)
    cols = [zeros] * compiled.num_cols + [zeros, ~zeros]
    for i, slot in enumerate(compiled.input_slots):
        cols[slot] = planes[i]
    for _, group in _groups(_decode(table)):
        results = []
        for _, a, b, c, o, invert, _ in group:
            va, vb, vc = cols[a], cols[b], cols[c]
            results.append((o, ((va & vb) | (vc & (va | vb))) ^ (~zeros if invert else zeros)))
        for o, value in results:
            cols[o] = value
    return torch.stack([cols[s] for s in compiled.output_slots])


@pytest.mark.parametrize("name,basis", CASES)
def test_packed_rows_unpack_to_the_schedule(name, basis):
    compiled = _port(name, basis)
    table = pb.pack_rows(compiled)
    assert table.dtype == torch.int32 and table.shape[1] == 2
    assert table.shape[0] % pb.ROW_CHUNK == 0
    rows = _decode(table)
    zero = compiled.num_cols
    real = [r for r in rows if r[4] != zero]
    unpacked = []
    for op, a, b, c, o, invert, _ in real:
        # The kernel's operands and inversion are those of loop_operands; the
        # fields the opcode does not read are 0 in the schedule.
        fields = [0, 0, 0]
        for slot in operand_slots(op):
            fields[slot] = (a, b, c)[slot]
        assert pb.loop_operands(op, *fields, zero) == (a, b, c, bool(invert))
        unpacked.append((op, *fields, o))
    np.testing.assert_array_equal(np.array(unpacked, dtype=np.int32).reshape(-1, 5),
                                  np.asarray(compiled.ops))
    for op, a, b, c, o, invert, _ in rows:
        if o == zero:  # padding: writes zero into the zero column
            assert (op, a, b, c, invert) == (pb.OP_INIT0, zero, zero, zero, 0)
    groups = _groups(rows)
    assert sum(len(g) for _, g in groups) == len(rows)
    for start, group in groups:
        assert 1 <= len(group) <= pb.GATE_GROUP
        assert start // pb.ROW_CHUNK == (start + len(group) - 1) // pb.ROW_CHUNK
        assert all(r[6] == 0 for r in group[1:])
        # Hazard-free: no row reads or rewrites a column written earlier in
        # its group.
        written = set()
        for _, a, b, c, o, _, _ in group:
            assert not ({a, b, c} & written) and (o not in written or o == zero)
            written.add(o)
    # Program order: the real rows' groups follow the wave chunks, cut at
    # GATE_GROUP, so no more groups than that.
    chunks = pb._wave_chunks([tuple(int(x) for x in r) for r in compiled.ops])
    n_real_groups = sum(1 for _, g in groups if g[0][4] != zero)
    assert n_real_groups == sum(-(-len(c) // pb.GATE_GROUP) for c in chunks)


@pytest.mark.parametrize("name,basis", CASES)
def test_table_walk_matches_interpreters(name, basis):
    compiled = _port(name, basis)
    ref_c = PROGRAMS[name](ref_pim, basis)
    rng = np.random.default_rng(len(name) + len(basis))
    planes = rng.integers(0, 2**32, (len(compiled.input_slots), W),
                          dtype=np.uint64).astype(np.uint32)
    tp = convert.planes_from_numpy(planes, device="cpu")
    got = _walk(pb.pack_rows(compiled), compiled, tp)
    assert torch.equal(got, ir.interpret(compiled, tp))
    want = np.asarray(ref_ir.get_backend("interpreter").run(
        ref_c, jnp.asarray(planes)).planes)
    np.testing.assert_array_equal(convert.planes_to_numpy(got), want)


@pytest.mark.parametrize("n_gates", [0, 3])
def test_short_schedule_tables(n_gates):
    """A schedule with no gates has an empty table (the kernel then fetches
    no stage); three gates fill one padded stage.  Either walks to what
    ``ir.interpret`` gives."""
    full = ir.compile_op("fixed_add", 8)
    compiled = dataclasses.replace(full, key=f"fixed_add8_first{n_gates}",
                                   ops=full.ops[:n_gates])
    table = pb.pack_rows(compiled)
    assert table.shape == (pb.ROW_CHUNK if n_gates else 0, 2)
    rng = np.random.default_rng(n_gates)
    planes = convert.planes_from_numpy(
        rng.integers(0, 2**32, (len(compiled.input_slots), W), dtype=np.uint64)
        .astype(np.uint32), device="cpu")
    assert torch.equal(_walk(table, compiled, planes), ir.interpret(compiled, planes))


def test_loop_table_refuses_what_the_kernel_cannot_take():
    fields = schedule_fields(ir.compile_op("fixed_add", 8))
    wide = convert.compiled_from_numpy(dict(fields, num_cols=pb.MAX_LOOP_COLS + 1))
    with pytest.raises(ValueError, match="12-bit"):
        pb.pack_rows(wide)
    # 2000 columns fit 12 bits, but not shared memory beside the row stages.
    deep = convert.compiled_from_numpy(dict(fields, num_cols=2000))
    with pytest.raises(ValueError, match="shared memory"):
        pb.pack_rows(deep)
    fits = convert.compiled_from_numpy(dict(fields, num_cols=1700))
    assert pb.pack_rows(fits).shape[0] == pb.ROW_CHUNK


def test_probe_versions_of_the_loop_kernel():
    """``benchmarks/torch_loop_probe.py`` swaps in an opcode dispatch for the
    branch-free gate (one ``run_group``, numbered as the port's opcodes)
    and packs groups of one gate, which still walk to the interpreter."""
    from benchmarks import torch_loop_probe as probe

    src = probe.switch_source()
    assert src.count("void run_group(") == 1 and "switch ((r.x >> 12) & 7u)" in src
    assert "maj3_xor(va[j]" not in src
    assert (pb.OP_NOR, pb.OP_INIT0, pb.OP_INIT1, pb.OP_COPY, pb.OP_NOT,
            pb.OP_MAJ3) == tuple(range(6)) and pb.OP_SHIFT == 12
    compiled = _port("int8_mac", "dram")
    one = probe.table_of(compiled, 1)
    assert pb.GATE_GROUP == 4
    assert all(len(g) == 1 for _, g in _groups(_decode(one)))
    planes = convert.planes_from_numpy(np.random.default_rng(7).integers(
        0, 2**32, (len(compiled.input_slots), W), dtype=np.uint64).astype(np.uint32),
        device="cpu")
    assert torch.equal(_walk(one, compiled, planes), ir.interpret(compiled, planes))


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
