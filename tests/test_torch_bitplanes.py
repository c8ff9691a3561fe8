"""repro_torch.core.bitplanes against the JAX reference: packed words equal
the numpy oracle, and every PimType packs and unpacks to the reference's
bits, including ±0, ±inf, NaN and subnormals.  Exact: the domain is
bitwise."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitplanes as ref_bp
from repro_torch.core import bitplanes as bp

N = 3001  # not a multiple of 32: the last word is partial

F32_SPECIALS = np.array(
    [0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 1e-45, -1e-45, 1.1754942e-38,
     5.9e-39, 3.4028235e38, -3.4028235e38], dtype=np.float32)


def _f32(rng) -> np.ndarray:
    bits = rng.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    v = bits.view(np.float32).copy()
    v[: len(F32_SPECIALS)] = F32_SPECIALS
    return v


def _bf16_as_f32(rng) -> np.ndarray:
    """float32 values exactly representable in bf16, so neither side rounds."""
    hi = rng.integers(0, 2**16, N, dtype=np.uint64).astype(np.uint32) << 16
    v = hi.view(np.float32).copy()
    v[:6] = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 9.2e-41], np.float32)
    return v


def _fixed(rng, nbits: int) -> np.ndarray:
    lo, hi = -(2 ** (nbits - 1)), 2 ** (nbits - 1)
    v = rng.integers(lo, hi, N).astype(np.int32)
    v[:3] = [lo, hi - 1, 0]
    return v


def _u32(planes) -> np.ndarray:
    return np.stack([np.asarray(p) for p in planes]).astype(np.uint32)


def _port_u32(planes) -> np.ndarray:
    return torch.stack(planes).numpy().view(np.uint32)


@pytest.mark.parametrize("n", [1, 31, 32, 33, 1000, N])
def test_pack_bits_matches_numpy_oracle(n):
    rng = np.random.default_rng(n)
    bits = rng.integers(0, 2, n).astype(np.int32)
    bits[-1] = 1
    if n >= 32:
        bits[31] = 1  # bit 31 is the int32 sign bit: it must survive packing
    words = bp.pack_bits(torch.from_numpy(bits))
    assert words.dtype == torch.int32
    np.testing.assert_array_equal(words.numpy().view(np.uint32),
                                  bp.np_pack_reference(bits))
    np.testing.assert_array_equal(bp.np_pack_reference(bits),
                                  ref_bp.np_pack_reference(bits))
    np.testing.assert_array_equal(bp.unpack_bits(words, n).numpy(), bits)


@pytest.mark.parametrize("name", ["fixed8", "fixed16", "fixed32", "f32", "bf16"])
def test_pimtype_planes_match_reference(name):
    rng = np.random.default_rng(7)
    if name == "f32":
        port_t, ref_t, x = bp.F32, ref_bp.F32, _f32(rng)
    elif name == "bf16":
        port_t, ref_t, x = bp.BF16, ref_bp.BF16, _bf16_as_f32(rng)
    else:
        nbits = int(name[5:])
        port_t, ref_t, x = bp.fixed(nbits), ref_bp.fixed(nbits), _fixed(rng, nbits)
    assert (port_t.name, port_t.kind, port_t.width, port_t.nbits) == (
        ref_t.name, ref_t.kind, ref_t.width, ref_t.nbits)

    ref_planes = ref_t.to_planes(ref_t.cast(x))
    port_planes = port_t.to_planes(port_t.cast(x, "cpu"))
    assert all(p.dtype == torch.int32 for p in port_planes)
    np.testing.assert_array_equal(_port_u32(port_planes), _u32(ref_planes))

    ref_back = np.asarray(ref_t.from_planes(ref_planes, N))
    port_back = port_t.from_planes(port_planes, N)
    if name == "bf16":
        np.testing.assert_array_equal(port_back.view(torch.int16).numpy().view(np.uint16),
                                      ref_back.view(np.uint16))
    elif name == "f32":
        np.testing.assert_array_equal(port_back.numpy().view(np.uint32),
                                      ref_back.view(np.uint32))
    else:
        np.testing.assert_array_equal(port_back.numpy(), ref_back)


def test_bf16_rounding_of_float32_matches_reference():
    """float32 → bf16 is round-to-nearest-even, NaN becomes a signed quiet
    NaN, as the reference's cast does (torch's own cast would not)."""
    rng = np.random.default_rng(3)
    x = _f32(rng)
    x[12:16] = np.array([1.0 + 2**-8, 1.0 + 3 * 2**-8, 3.3895314e38, -3.3895314e38],
                        np.float32)
    ref_bits = np.asarray(jnp.asarray(x, jnp.bfloat16)).view(np.uint16)
    port_bits = bp.f32_to_bf16_bits(torch.from_numpy(x)).numpy().astype(np.uint16)
    np.testing.assert_array_equal(port_bits, ref_bits)


@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.int64, np.uint32])
def test_fixed_planes_accept_integer_dtypes(dtype):
    """Narrow, wide and unsigned integer inputs pack their low bits exactly
    as the reference packs them."""
    rng = np.random.default_rng(11)
    info = np.iinfo(dtype)
    x = rng.integers(max(info.min, -2**40), min(info.max, 2**40), N, dtype=np.int64)
    x = x.astype(dtype)
    port = bp.fixed(32).to_planes(bp.fixed(32).cast(x, "cpu"))
    ref = ref_bp.fixed(32).to_planes(ref_bp.fixed(32).cast(
        x.astype(np.int64).astype(np.uint32)))
    np.testing.assert_array_equal(_port_u32(port), _u32(ref))


def test_unsigned_decode_and_word_views():
    x = np.array([0, 1, 2**31, 2**32 - 1], dtype=np.uint32)
    planes = bp.int_to_planes(bp.as_int32_words(x), 32)
    got = bp.planes_to_int(planes, 4, signed=False)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), x.astype(np.int64))
    assert bp.num_words(33) == 2 and bp.num_words(32) == 1
