"""The plain reference, the control and the comparison on hand-made values."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pimbench import inputs, reference

F32_MAC = {"args": ["a", "b", "c"], "expr": "a * b + c", "dtype": "f32"}
INT8_MAC = {"args": ["a", "b", "c"], "expr": "a * b + c", "dtype": "int8"}
ONE_ULP = np.float32(1 + 2**-23)


def f32(*values) -> np.ndarray:
    return np.array(values, dtype=np.float32)


def test_f32_mac_special_values():
    a = f32(np.inf, 1e-45, -0.0, 3.4028235e38, np.nan, 1.0, ONE_ULP)
    b = f32(0.0, 1.0, 1.0, 2.0, 1.0, -1.0, ONE_ULP)
    c = f32(1.0, 0.0, 0.0, 1.0, 0.0, 1.0, -1.0)
    got = reference.reference(F32_MAC, [a, b, c])
    assert got.dtype == np.float32
    assert np.isnan(got[0]) and np.isnan(got[4])  # inf * 0, NaN * 1
    assert got[1] == np.float32(1e-45)  # a subnormal survives
    assert got[2].view(np.uint32) == 0  # -0 * 1 + 0 is +0
    assert np.isinf(got[3]) and got[3] > 0  # overflow
    assert got[5].view(np.uint32) == 0  # 1 * -1 + 1 is +0
    # The product rounds before the sum (no fused multiply-add): 2^-22, not
    # 2^-22 + 2^-46.
    assert got[6] == np.float32(2.0**-22)


def test_int8_mac_wraps_each_operation():
    a = np.array([127, -128, 100, -1], dtype=np.int8)
    b = np.array([2, -1, 100, 1], dtype=np.int8)
    c = np.array([1, 0, 0, -128], dtype=np.int8)
    assert reference.reference(INT8_MAC, [a, b, c]).tolist() == [-1, -128, 16, 127]


def test_comparison_is_bit_exact_with_nan_as_nan():
    want = f32(np.nan, 0.0, 1.0, -np.inf)
    assert reference.wrong_rows(F32_MAC, f32(-np.nan, 0.0, 1.0, -np.inf), want) == 0
    assert reference.wrong_rows(F32_MAC, f32(np.nan, -0.0, 1.0, -np.inf), want) == 1
    assert reference.wrong_rows(F32_MAC, f32(1.0, 0.0, ONE_ULP, np.nan), want) == 3
    assert reference.wrong_rows(F32_MAC, f32(np.nan, 0.0), want) == 4
    assert reference.wrong_rows(INT8_MAC, np.array([1, 2], np.int32), np.array([1, -2])) == 1


def test_control_is_lower_precision():
    a, b, c = (torch.tensor([ONE_ULP, 3.0]), torch.tensor([ONE_ULP, 5.0]),
               torch.tensor([-1.0, 1e-3]))
    got = reference.control(F32_MAC, [a, b, c]).numpy()
    want = reference.reference(F32_MAC, [a.numpy(), b.numpy(), c.numpy()])
    assert got.dtype == np.float32 and reference.wrong_rows(F32_MAC, got, want) == 2
    x = torch.tensor([7, 9], dtype=torch.int8)
    low = reference.control(INT8_MAC, [x, x, x])
    assert low.dtype == torch.int32 and low.tolist() == [-8, -6]  # wrap4(7 * 7) + 7, wrap4(-7 * -7) - 7


@pytest.mark.parametrize("expr", ["__import__('os')", "a.real", "a ** 2", "a @ b", "d * a",
                                  "a if b else c", "'s'"])
def test_only_arithmetic_is_taken(expr):
    with pytest.raises(ValueError):
        reference.parse(expr, ["a", "b", "c"])


def test_the_lambda_is_the_expression():
    fn = reference.as_lambda({"args": ["a", "b", "c"], "expr": "a * b + c - 2.5"})
    assert fn(2.0, 3.0, 1.0) == 4.5
    assert reference.elem_type("int8").nbits == 8
    with pytest.raises(ValueError):
        reference.elem_type("bf16")


def test_inputs_repeat_and_hold_the_specials():
    one = inputs.make_pool("f32", 3, 2, 4096, 256, 2**31 + 7, "cpu")
    two = inputs.make_pool("f32", 3, 2, 4096, 256, 2**31 + 7, "cpu")
    assert one.dtype == torch.float32 and torch.equal(one.view(torch.int32),
                                                      two.view(torch.int32))
    for k in range(3):
        rows = inputs.special_rows(k, 4096, 256)
        got = one[1, k, torch.as_tensor(rows)].numpy()
        assert np.array_equal(got.view(np.uint32)[~np.isnan(got)],
                              np.roll(inputs.F32_SPECIALS, k).view(np.uint32)[~np.isnan(got)])
    v = one.numpy()
    tiny = np.abs(v[np.isfinite(v)])
    assert ((tiny > 0) & (tiny < 2.0**-126)).sum() > 100  # subnormals beyond the specials
    assert not torch.equal(one, inputs.make_pool("f32", 3, 2, 4096, 256, 8, "cpu"))
    ints = inputs.make_pool("int8", 3, 2, 4096, 256, 5, "cpu")
    assert ints.dtype == torch.int8 and int(ints.min()) == -128 and int(ints.max()) == 127


def test_powers_of_two_are_exact():
    e = torch.arange(-149, 128, dtype=torch.int32)
    got = inputs._powers_of_two(e).numpy().astype(np.float64)
    assert np.array_equal(got, np.ldexp(1.0, e.numpy()))
