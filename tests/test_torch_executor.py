"""The port's executors on the CPU, separated from its compiler: reference
schedules carried across with ``convert.compiled_from_numpy`` run through
the plain loop and plain straight-line versions in every mode and equal the
reference ``interpreter`` word for word; the wave chunking, segmentation
and CUDA code generation keep their contracts; and a rebound schedule key
never replays a stale artifact."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_ref import MAC, schedule_fields

import repro.pim as ref_pim
from repro.core import ir as ref_ir
from repro.kernels import pim_bitserial as ref_pb
from repro.kernels import ref as ref_ref
from repro_torch import convert
from repro_torch.core import bitplanes, ir
from repro_torch.kernels import bitserial_codegen, pim_bitserial, ref

W = 77  # packed words: not a multiple of 32 or of BLOCK_WORDS

SCHEDULES = {
    "f32_mac_memristive": lambda: ref_pim.compile(MAC, dtype=ref_pim.f32).compiled(),
    "f32_mac_dram": lambda: ref_pim.compile(MAC, dtype=ref_pim.f32).compiled("dram"),
    "int8_mac_memristive": lambda: ref_pim.compile(MAC, dtype=ref_pim.int8).compiled(),
    "fixed_add32_dram": lambda: ref_ir.compile_op("fixed_add", 32, basis="dram"),
}


def _planes(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, (n, W), dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_carried_schedule_matches_reference_interpreter(name):
    ref_c = SCHEDULES[name]()
    port_c = convert.compiled_from_numpy(schedule_fields(ref_c))
    planes = _planes(len(ref_c.input_slots), seed=len(name))
    want = np.asarray(ref_ir.get_backend("interpreter").run(
        ref_c, jnp.asarray(planes)).planes)
    tp = convert.planes_from_numpy(planes, device="cpu")
    key = pim_bitserial.register_compiled(port_c, f"carried/{name}")
    for mode in ("auto", "loop", "unrolled"):
        got = pim_bitserial.run_schedule(key, tp, mode=mode)
        np.testing.assert_array_equal(convert.planes_to_numpy(got), want)
    for backend in ("interpreter", "cuda", "cuda-loop", "cuda-unrolled"):
        got = ir.get_backend(backend).run(port_c, tp).planes
        np.testing.assert_array_equal(convert.planes_to_numpy(got), want)
    if name == "f32_mac_memristive":
        # The forced straight-line f32 MAC: 13 segments threading the state.
        assert len(pim_bitserial._segments(port_c)) == 13


def test_segments_and_chunks_match_reference():
    ref_c = SCHEDULES["f32_mac_dram"]()
    port_c = convert.compiled_from_numpy(schedule_fields(ref_c))
    assert pim_bitserial._segments(port_c) == ref_pb._segments(ref_c)
    assert len(pim_bitserial._segments(port_c)) == 9


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_wave_chunks_hazard_free_and_segments_bounded(name):
    compiled = convert.compiled_from_numpy(schedule_fields(SCHEDULES[name]()))
    rows = [tuple(int(x) for x in r) for r in compiled.ops]
    chunks = pim_bitserial._wave_chunks(rows)
    assert [r for chunk in chunks for r in chunk] == rows
    for chunk in chunks:
        written = set()
        for op, a, b, c, o in chunk:
            reads = {(a, b, c)[s] for s in ir.operand_slots(op)}
            assert not reads & written and o not in written
            written.add(o)
    segments = pim_bitserial._segments(compiled)
    assert [c for seg in segments for c in seg] == chunks
    assert all(sum(map(len, seg)) <= pim_bitserial.UNROLL_SEGMENT_GATES
               for seg in segments)


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_codegen_one_statement_per_gate_per_segment(name):
    compiled = convert.compiled_from_numpy(schedule_fields(SCHEDULES[name]()))
    segments = pim_bitserial._segments(compiled)
    src = bitserial_codegen.generate(compiled, segments)
    bodies = re.split(r"__global__ void __launch_bounds__\(\d+\)\n", src)[1:]
    assert len(bodies) == len(segments)
    assert f"bitserial_segment_count() {{ return {len(segments)}; }}" in src
    for s, (body, chunks) in enumerate(zip(bodies, segments)):
        assert body.startswith(f"bitserial_seg{s}(")
        gates = re.findall(r"^    const uint32_t t\d+ = .*;$", body, re.M)
        assert len(gates) == sum(map(len, chunks))
        assert body.count("  {\n") == len(chunks)
    if len(segments) == 1:
        assert "state[" not in src  # one segment reads inputs, writes outputs
    assert src.count("out[") == len(compiled.output_slots)


def test_segment_plan_threads_state():
    compiled = convert.compiled_from_numpy(schedule_fields(SCHEDULES["f32_mac_dram"]()))
    segments = pim_bitserial._segments(compiled)
    stored = set()
    for s, chunks in enumerate(segments):
        first, last = s == 0, s == len(segments) - 1
        loads, stores, written = bitserial_codegen.segment_plan(
            chunks, first, last, compiled.input_slots, compiled.output_slots)
        if not first:
            assert set(loads) <= stored  # every column a segment loads was stored
        stored |= set(stores)
        assert last or set(written) <= set(stores)
        assert not (last and stores)


def test_plain_versions_match_reference_oracle():
    ref_c = ref_ir.compile_op("fixed_mul", 8)
    port_c = convert.compiled_from_numpy(schedule_fields(ref_c))
    planes = _planes(len(ref_c.input_slots), seed=3)
    want = np.asarray(ref_ref.bitserial_ref(ref_c.to_schedule(), jnp.asarray(planes)))
    tp = convert.planes_from_numpy(planes, device="cpu")
    got = ref.bitserial_ref(port_c.to_schedule(), tp)
    np.testing.assert_array_equal(convert.planes_to_numpy(got), want)
    np.testing.assert_array_equal(
        convert.planes_to_numpy(pim_bitserial.loop_plain(port_c, tp)), want)
    np.testing.assert_array_equal(
        convert.planes_to_numpy(pim_bitserial.unrolled_plain(port_c, tp)), want)


def test_planes_round_trip_and_fields():
    planes = _planes(3, seed=9)
    t = convert.planes_from_numpy(planes, device="cpu")
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(convert.planes_to_numpy(t), planes)
    with pytest.raises(TypeError):
        convert.planes_from_numpy(planes.astype(np.int64), device="cpu")
    with pytest.raises(KeyError):
        convert.compiled_from_numpy({"ops": np.zeros((0, 5))})


def test_rebound_key_does_not_replay_stale_kernel():
    """Re-registering different schedule content under an existing key must
    drop every per-key artifact (gate table, segments, generated source), in
    either executor mode."""
    add = ir.compile_op("fixed_add", 8)
    sub = ir.compile_op("fixed_sub", 8)
    x = torch.tensor([10, 7], dtype=torch.int32)
    y = torch.tensor([3, 2], dtype=torch.int32)
    planes = torch.stack(bitplanes.int_to_planes(x, 8) + bitplanes.int_to_planes(y, 8))

    def run(mode):
        out = pim_bitserial.run_schedule("rebound", planes, mode=mode)
        return bitplanes.planes_to_int([out[i] for i in range(8)], 2).tolist()

    pim_bitserial.register_schedule("rebound", add)
    assert run("unrolled") == [13, 9] and run("loop") == [13, 9]
    add_source = pim_bitserial.unrolled_source("rebound")
    gen = pim_bitserial._GENERATIONS["rebound"]
    pim_bitserial.register_schedule("rebound", sub)
    assert pim_bitserial._GENERATIONS["rebound"] == gen + 1
    assert run("unrolled") == [7, 5] and run("loop") == [7, 5]
    assert pim_bitserial.unrolled_source("rebound") != add_source
    # A legacy machine.Schedule is wrapped as-is under the key.
    pim_bitserial.register_schedule("rebound", add.to_schedule())
    assert run("unrolled") == [13, 9] and run("loop") == [13, 9]


def test_loop_kernel_block_and_validation():
    assert pim_bitserial.words_per_block(160) == 256
    assert pim_bitserial.words_per_block(163) == 256  # fixed_div, the widest op
    assert pim_bitserial.words_per_block(300) == 192
    with pytest.raises(ValueError):
        pim_bitserial.words_per_block(2000)
    bad = ir.compile_op("fixed_add", 8)
    bad = convert.compiled_from_numpy(dict(schedule_fields(bad), num_cols=4))
    with pytest.raises(ValueError, match="outside"):
        pim_bitserial.register_compiled(bad, "bad-columns")
    assert "bad-columns" not in pim_bitserial._SCHEDULES
    pim_bitserial.register_compiled(ir.compile_op("fixed_add", 8), "validate")
    with pytest.raises(ValueError, match="expects 16 stacked"):
        pim_bitserial.run_schedule("validate", torch.zeros((3, 4), dtype=torch.int32))
    with pytest.raises(TypeError, match="int32"):
        pim_bitserial.run_schedule("validate", torch.zeros((16, 4), dtype=torch.int64))


def test_semantic_oracles_match_reference():
    rng = np.random.default_rng(4)
    x, y = (rng.standard_normal(300).astype(np.float32) for _ in range(2))
    a, b = (rng.integers(-2**31, 2**31, 300).astype(np.int32) for _ in range(2))
    tx, ty, ta, tb = (torch.from_numpy(v) for v in (x, y, a, b))
    for port_fn, ref_fn, args in ((ref.float_add_ref, ref_ref.float_add_ref, (x, y)),
                                  (ref.float_mul_ref, ref_ref.float_mul_ref, (x, y)),
                                  (ref.fixed_add_ref, ref_ref.fixed_add_ref, (a, b))):
        targs = (tx, ty) if args[0] is x else (ta, tb)
        got = port_fn(*targs).numpy()
        want = np.asarray(ref_fn(*(jnp.asarray(v) for v in args)))
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_planes_from_numpy_defaults_to_the_card(monkeypatch):
    """With no device, planes go to the card, as every entry point's do;
    with no card that raises instead of quietly staying on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.planes_from_numpy(_planes(2, seed=4))
    assert convert.planes_from_numpy(_planes(2, seed=4), device="cpu").device.type == "cpu"
