"""The port's compiler against the JAX reference on the memristive basis:
for every ``_OP_TABLE`` op (fixed ops at 8, 16 and 32 bits) and the fused
f32/bf16/int8/int16 MACs, ``CompiledSchedule`` equals the reference's row
for row.  ``test_torch_compiler_dram.py`` holds the dram basis."""

import dataclasses

import pytest
from _torch_ref import MAC, OP_CASES, assert_pinned, assert_same_compiled

import repro.pim as ref_pim
import repro_torch.pim as pim
from repro.core import aritpim as ref_aritpim
from repro.core import ir as ref_ir
from repro_torch.core import aritpim, ir

BASIS = "memristive"


@pytest.fixture(autouse=True)
def fresh_compile_caches(monkeypatch):
    """Both sides compile anew in each test.  The compile caches key a bf16
    op without its width, so an entry another test file made at 16 bits on
    one side only would bring its schedule key ("bf16_add/16@...") into the
    comparison."""
    monkeypatch.setattr(ir, "_COMPILE_CACHE", {})
    monkeypatch.setattr(ref_ir, "_COMPILE_CACHE", {})

def test_op_table_is_the_reference_table():
    assert list(aritpim._OP_TABLE) == list(ref_aritpim._OP_TABLE)
    assert {op for op, _ in OP_CASES} == set(ref_aritpim._OP_TABLE)
    for name, spec in aritpim._OP_TABLE.items():
        ref = ref_aritpim._OP_TABLE[name]
        assert (spec.arith, spec.dtype) == (ref.arith, ref.dtype)
        for n in (8, 16, 32):
            assert aritpim.op_widths(name, n) == ref_aritpim.op_widths(name, n)


@pytest.mark.parametrize("op,nbits", OP_CASES)
def test_compiled_op_matches_reference(op, nbits):
    port = ir.compile_op(op, nbits, basis=BASIS)
    ref = ref_ir.compile_op(op, nbits, basis=BASIS)
    assert_same_compiled(port, ref)
    assert_pinned((op, nbits), port, BASIS)


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8", "int16"])
def test_compiled_mac_matches_reference(dtype):
    port = pim.compile(MAC, dtype=getattr(pim, dtype)).compiled(BASIS)
    ref = ref_pim.compile(MAC, dtype=getattr(ref_pim, dtype)).compiled(BASIS)
    assert_same_compiled(port, ref)
    assert_pinned((dtype, "mac"), port, BASIS)


def test_cost_report_matches_reference():
    port = ir.get_backend("cost").run(ir.compile_op("float_mul", basis=BASIS)).cost
    ref = ref_ir.get_backend("cost").run(ref_ir.compile_op("float_mul", basis=BASIS)).cost
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert ir.netlist_gate_counts(8) == ref_ir.netlist_gate_counts(8)
