"""The port's compiler against the JAX reference on the dram basis:
for every ``_OP_TABLE`` op (fixed ops at 8, 16 and 32 bits) and the fused
f32/bf16/int8/int16 MACs, ``CompiledSchedule`` equals the reference's row
for row.  ``test_torch_compiler.py`` holds the memristive basis."""

import dataclasses

import pytest
from _torch_ref import MAC, OP_CASES, assert_pinned, assert_same_compiled

import repro.pim as ref_pim
import repro_torch.pim as pim
from repro.core import ir as ref_ir
from repro_torch.core import ir

BASIS = "dram"


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
