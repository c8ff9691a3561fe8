"""The slice as a whole: ``repro_torch.pim.compile(...)(..., device="cpu")``
equals ``repro.pim.compile(..., backend="interpreter")`` bit for bit on both
bases, traces share the reference's ``Program.key``, and no call runs on
the CPU unless asked to."""

import numpy as np
import pytest
import torch
from _torch_ref import MAC, inputs

import repro.pim as ref_pim
import repro_torch.pim as pim
from repro_torch.kernels import ops, pim_bitserial

N = 2053  # not a multiple of 32 or of the executors' block


def _bits(x) -> np.ndarray:
    """Raw bit patterns of a result, from either package."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        x = x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.itemsize == 2 else x.view(np.uint32)


CASES = [
    ("f32", MAC), ("bf16", MAC), ("int8", MAC), ("int16", MAC),
    ("f32", lambda a, b: a * b + 2.5),
]


@pytest.mark.parametrize("basis", ["memristive", "dram"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_compiled_program_matches_reference_interpreter(case, basis):
    name, fn = CASES[case]
    port_t, ref_t = getattr(pim, name), getattr(ref_pim, name)
    n_args = fn.__code__.co_argcount
    args = inputs(port_t.kind, port_t.nbits, N, n_args, seed=case)
    port_fn = pim.compile(fn, dtype=port_t)
    ref_fn = ref_pim.compile(fn, dtype=ref_t, backend="interpreter")
    assert port_fn.program.key == ref_fn.program.key
    got = port_fn(*args, basis=basis, device="cpu")
    want = ref_fn(*args, basis=basis)
    assert got.device.type == "cpu" and got.shape == (N,)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # Every executor mode computes the same function.
    for mode in ("loop", "unrolled"):
        np.testing.assert_array_equal(
            _bits(port_fn(*args, basis=basis, device="cpu", mode=mode)), _bits(want))


def test_same_lambda_same_program_key_and_cache_entry():
    a = pim.compile(lambda x, y, z: x * y + z, dtype=pim.f32)
    b = pim.compile(lambda p, q, r: p * q + r, dtype=pim.f32)
    ref = ref_pim.compile(lambda x, y, z: x * y + z, dtype=ref_pim.f32)
    assert a.program.key == b.program.key == ref.program.key
    assert a.compiled() is b.compiled()
    single = pim.compile(lambda x, y: x + y, dtype=pim.f32)
    assert single.program.key == ref_pim.compile(
        lambda x, y: x + y, dtype=ref_pim.f32).program.key
    assert single.compiled().key.startswith("float_add/32@")


def test_scalar_constants_encode_like_reference():
    from repro.pim import frontend as ref_frontend
    from repro_torch.pim import frontend

    for name, values in (("f32", [2.5, -0.1, 1e39, 3, 2**35]),
                         ("bf16", [2.5, -0.1, 1.00390625, 3]),
                         ("int8", [3, -1, 200, -129]), ("int16", [-7, 40000])):
        for v in values:
            assert frontend._encode_scalar(v, getattr(pim, name)) == \
                ref_frontend._encode_scalar(v, getattr(ref_pim, name)), (name, v)
    with pytest.raises(pim.TraceError):
        pim.compile(lambda a: a + 0.5, dtype=pim.int8)


def test_wrappers_match_numpy_on_cpu():
    x, y = inputs("float32", 32, N, 2, seed=5)
    with np.errstate(all="ignore"):
        want = x + y
    got = ops.pim_float_add(x, y, device="cpu").numpy()
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.uint32), want[~nan].view(np.uint32))
    a, b = inputs("fixed", 32, N, 2, seed=6)
    with np.errstate(all="ignore"):
        np.testing.assert_array_equal(
            ops.pim_fixed_add(torch.from_numpy(a), torch.from_numpy(b),
                              device="cpu", basis="dram").numpy(), a + b)
    a8, b8 = (v.astype(np.int8) for v in inputs("fixed", 8, N, 2, seed=7))
    np.testing.assert_array_equal(
        ops.pim_fixed_mul(a8, b8, nbits=8, device="cpu").numpy(),
        (a8 * b8).astype(np.int32))
    from repro.kernels import ops as ref_ops

    assert ops.schedule_info("float_add", basis="dram") == ref_ops.schedule_info(
        "float_add", basis="dram")


def test_no_silent_cpu_fallback(monkeypatch):
    """Without a card, a call that does not ask for the CPU raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, y, z = inputs("float32", 32, 64, 3, seed=1)
    mac = pim.compile(MAC, dtype=pim.f32)
    before = dict(pim_bitserial.LAUNCHES)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mac(x, y, z)
    with pytest.raises(RuntimeError):
        mac(x, y, z, device="cuda")
    with pytest.raises(RuntimeError):
        ops.pim_fixed_add(np.arange(4, dtype=np.int32), np.arange(4, dtype=np.int32))
    assert pim_bitserial.LAUNCHES == before
    assert mac(x, y, z, device="cpu").device.type == "cpu"


def test_mode_only_applies_to_cuda_backends():
    x, y, z = inputs("float32", 32, 64, 3, seed=2)
    mac = pim.compile(MAC, dtype=pim.f32)
    with pytest.raises(ValueError, match="only applies"):
        mac(x, y, z, device="cpu", backend="interpreter", mode="loop")
    with pytest.raises(ValueError, match="unknown executor mode"):
        mac(x, y, z, device="cpu", mode="fast")
