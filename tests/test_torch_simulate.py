"""The port's bit-exact simulation wrappers on the CPU against the JAX
reference: every wrapper's result is bit-equal at 257 elements that include
±0, ±inf, NaN and subnormals, and its OpCost (with the lazy dram fields)
and the fused-MAC cost reports are equal on both bases."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_ref import inputs

from repro.core import bitplanes as ref_bp
from repro.core import simulate as ref_sim
from repro_torch.core import bitplanes, simulate

N = 257

# wrapper name -> (input kind, nbits, arity, extra kwargs)
CASES = {
    **{f"fixed_{op}{n}": ("fixed", n, 2, op) for op in ("add", "mul", "div") for n in (8, 16, 32)},
    "fixed_mul_full32": ("fixed", 32, 2, "mul_full"),
    "float_add": ("f32", 32, 2, None), "float_sub": ("f32", 32, 2, None),
    "float_mul": ("f32", 32, 2, None), "float_div": ("f32", 32, 2, None),
    "bf16_add": ("bf16", 16, 2, None), "bf16_mul": ("bf16", 16, 2, None),
    "float_mac": ("f32", 32, 3, None),
}


def _bits(x) -> np.ndarray:
    """A result as its raw bit patterns (int64), NaN payloads included."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        elif x.dtype == torch.float32:
            x = x.view(torch.int32)
        return x.numpy().astype(np.int64)
    x = np.asarray(x)
    if x.dtype.itemsize == 2 and x.dtype.kind not in "iu":
        x = x.view(np.int16)
    elif x.dtype == np.float32:
        x = x.view(np.int32)
    return x.astype(np.int64)


@pytest.mark.parametrize("name", list(CASES))
def test_wrapper_bit_equal_to_reference(name):
    kind, nbits, arity, op = CASES[name]
    arrays = inputs("fixed" if kind == "fixed" else kind, nbits, N, arity, seed=len(name))
    if kind == "fixed":
        fn = "fixed_mul_full" if op == "mul_full" else f"fixed_{op}"
        kw = {"nbits": nbits}
        ref_args = [jnp.asarray(a) for a in arrays]
    else:
        fn, kw = name, {}
        jdt = jnp.bfloat16 if kind == "bf16" else jnp.float32
        ref_args = [jnp.asarray(a, jdt) for a in arrays]
    want, want_cost = getattr(ref_sim, fn)(*ref_args, **kw)
    got, got_cost = getattr(simulate, fn)(*arrays, device="cpu", **kw)
    if op == "mul_full":
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int64))
    else:
        assert got.device.type == "cpu" and got.shape == (N,)
        np.testing.assert_array_equal(_bits(got), _bits(want))
    assert dataclasses.asdict(got_cost) == dataclasses.asdict(want_cost)
    if isinstance(got_cost, simulate.OpCost):
        for prop in ("compute_complexity", "dram_gates", "dram_maj_gates",
                     "dram_cycles", "dram_peak_rows"):
            assert getattr(got_cost, prop) == getattr(want_cost, prop), prop


@pytest.mark.parametrize("basis", ["memristive", "dram"])
@pytest.mark.parametrize("dtype", ["F32", "BF16", "int8", "int16"])
def test_mac_cost_equal_to_reference(dtype, basis):
    if dtype.startswith("int"):
        port_t, ref_t = bitplanes.fixed(int(dtype[3:])), ref_bp.fixed(int(dtype[3:]))
    else:
        port_t, ref_t = getattr(bitplanes, dtype), getattr(ref_bp, dtype)
    got = simulate.mac_cost(port_t, basis=basis)
    want = ref_sim.mac_cost(ref_t, basis=basis)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.hbm_planes == want.hbm_planes


def test_simulate_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        simulate.fixed_add(np.int32([1]), np.int32([2]))
