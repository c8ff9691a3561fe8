"""Shared helpers for the repro_torch tests: the same inputs, made with
numpy from a seed, for the JAX reference and the port."""

import numpy as np

MAC = lambda a, b, c: a * b + c  # noqa: E731

OP_CASES = [(op, nbits) for op in (
    "fixed_add", "fixed_sub", "fixed_mul", "fixed_mul_unsigned", "fixed_div",
    "float_add", "float_sub", "float_mul", "float_div",
    "bf16_add", "bf16_sub", "bf16_mul")
            for nbits in ((8, 16, 32) if op.startswith("fixed") else (32,))]

# ROADMAP's targets (gates / cols / waves), memristive | dram.
PINNED = {
    ("fixed_add", 32): ((286, 66, 68), (130, 68, 35)),
    ("float_add", 32): ((3270, 108, 333), (2651, 110, 197)),
    ("float_mul", 32): ((9707, 128, 520), (6029, 123, 283)),
    ("f32", "mac"): ((12968, 160, 850), (8697, 155, 476)),
    ("bf16", "mac"): ((3893, 85, 452), (2846, 81, 273)),
    ("int8", "mac"): ((632, 39, 80), (428, 42, 47)),
    ("int16", "mac"): ((1928, 79, 144), (1192, 82, 79)),
}


def assert_pinned(key, compiled, basis):
    """(gates, cols, waves) of the pinned programs."""
    if key in PINNED:
        want = PINNED[key][0 if basis == "memristive" else 1]
        assert (compiled.num_gates, compiled.num_cols, compiled.num_waves) == want


F32_SPECIALS = np.array(
    [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45, 1.1754942e-38,
     5.9e-39, 3.4028235e38, -3.4028235e38, 1.0], dtype=np.float32)


def inputs(kind: str, nbits: int, n: int, count: int, seed: int):
    """``count`` numpy arrays of ``n`` elements for a PimType of ``kind``.
    Floats are random bit patterns with ±0/±inf/NaN/subnormals placed at
    the front; bf16 values are float32 values exactly representable in
    bf16, so neither side rounds on packing."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(count):
        if kind == "fixed":
            lo, hi = -(2 ** (nbits - 1)), 2 ** (nbits - 1)
            out.append(rng.integers(lo, hi, n).astype(np.int32))
            continue
        bits = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
        if kind == "bf16":
            bits &= np.uint32(0xFFFF0000)
        v = bits.view(np.float32).copy()
        v[: len(F32_SPECIALS)] = np.roll(F32_SPECIALS, 3 * k)
        if kind == "bf16":
            v = (v.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)
        out.append(v)
    return out


def schedule_fields(compiled) -> dict:
    """A compiled schedule as numpy/plain Python (the convert contract)."""
    return dict(
        key=compiled.key, ops=np.asarray(compiled.ops), num_cols=compiled.num_cols,
        input_cols=compiled.input_cols, output_cols=compiled.output_cols,
        recorded_len=compiled.recorded_len, recorded_gates=compiled.recorded_gates,
        basis=compiled.basis, meta=compiled.meta)


def assert_same_compiled(port, ref) -> None:
    """Row-for-row equality of two compiled schedules and their metadata."""
    np.testing.assert_array_equal(port.ops, ref.ops)
    assert port.key == ref.key
    assert port.num_cols == ref.num_cols
    assert port.input_cols == ref.input_cols
    assert port.output_cols == ref.output_cols
    assert port.recorded_len == ref.recorded_len
    assert port.recorded_gates == ref.recorded_gates
    assert port.num_waves == ref.num_waves
    assert port.basis == ref.basis
    assert port.pass_log == ref.pass_log
    assert port.meta == ref.meta
