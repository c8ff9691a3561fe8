"""``PimType.to_planes`` into a given buffer and ``from_planes`` from a
strided view, on the CPU (the plain PyTorch path, against NumPy), and the
packing kernels of ``kernels/pim_bitplanes.py`` bit for bit against that
path on the card (``gpu`` marker; decided in the fixture, so every worker
collects the same tests).  The card tests need only torch:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_bitplane_kernels.py
"""

import numpy as np
import pytest
import torch

import repro_torch.pim as pim
from repro_torch.core import bitplanes as bp
from repro_torch.kernels import pim_bitplanes

SIZES = [1, 31, 32, 33, 1000]
CARD_SIZES = SIZES + [(1 << 20) + 7]
FIXED = [bp.fixed(n) for n in (1, 7, 8, 16, 31, 32)]
INT_CARRIERS = [torch.int8, torch.int16, torch.int32, torch.int64, torch.uint8]
# (type, carrier) pairs: every fixed width with every integer carrier, f32
# from float32, bf16 from bfloat16 and from float32.
CASES = ([(t, c) for t in FIXED for c in INT_CARRIERS]
         + [(bp.F32, torch.float32), (bp.BF16, torch.bfloat16), (bp.BF16, torch.float32)])
CASE_IDS = [f"{t.name}-{str(c).split('.')[-1]}" for t, c in CASES]
F32_SPECIALS = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45, 1.1754942e-38,
                         1e-40, -3e-39, 3.4028235e38, -3.4028235e38, 1.0, -1.0],
                        dtype=np.float32)
# NaNs with payloads: quiet and signalling, both signs.
NAN_BITS = np.array([0x7FC00000, 0xFFC00000, 0x7F800001, 0xFF812345, 0x7FFFFFFF],
                    dtype=np.uint32)


def _rows(carrier: torch.dtype, n: int, seed: int) -> torch.Tensor:
    """``n`` rows of ``carrier`` over its range (specials for floats)."""
    rng = np.random.default_rng(seed)
    if carrier == torch.uint8:
        return torch.from_numpy(rng.integers(0, 256, n).astype(np.uint8))
    if carrier == torch.int64:
        return torch.from_numpy(rng.integers(-2**40, 2**40, n))
    if not carrier.is_floating_point:
        info = torch.iinfo(carrier)
        return torch.from_numpy(rng.integers(info.min, info.max + 1, n)).to(carrier)
    x = (rng.standard_normal(n) * np.exp2(rng.integers(-140, 120, n))).astype(np.float32)
    k = min(n, len(F32_SPECIALS))
    x[:k] = F32_SPECIALS[:k]
    x[k:k + len(NAN_BITS)] = NAN_BITS[:max(0, min(len(NAN_BITS), n - k))].view(np.float32)
    return torch.from_numpy(x).to(carrier)


def _bits(t: bp.PimType, x: torch.Tensor) -> np.ndarray:
    """The planes' bits a row, as int64 (NumPy: the oracle)."""
    if t.kind == "float32":
        return x.numpy().view(np.uint32).astype(np.int64)
    if t.kind == "bf16":
        return (x.view(torch.int16).numpy().astype(np.int64) & 0xFFFF
                if x.dtype == torch.bfloat16 else bp.f32_to_bf16_bits(x).numpy().astype(np.int64))
    return x.numpy().astype(np.int64)


def _oracle_planes(t: bp.PimType, x: torch.Tensor) -> np.ndarray:
    bits = _bits(t, x)
    return np.stack([bp.np_pack_reference(((bits >> j) & 1).astype(np.uint32))
                     for j in range(t.width)]).view(np.int32)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("t,carrier", CASES, ids=CASE_IDS)
def test_to_planes_into_rows_equals_the_list(t, carrier, n):
    x = _rows(carrier, n, seed=n)
    listed = t.to_planes(x)
    out = torch.full((t.width, bp.num_words(n)), 0x5A5A5A5A, dtype=torch.int32)
    assert t.to_planes(x, out=out) is out
    assert torch.equal(out, torch.stack(listed))
    np.testing.assert_array_equal(out.numpy(), _oracle_planes(t, x))
    assert torch.equal(t.from_planes(out, n).view(torch.int8),
                       t.from_planes(listed, n).view(torch.int8))


@pytest.mark.parametrize("t", [bp.F32, bp.BF16, bp.fixed(8), bp.fixed(32)], ids=lambda t: t.name)
def test_to_planes_into_a_strided_row_view(t):
    n, words = 1000, bp.num_words(1000)
    x = _rows(torch.float32 if t.kind != "fixed" else torch.int32, n, seed=1)
    buf = torch.full((t.width + 2, words + 5), 7, dtype=torch.int32)
    out = buf[1:1 + t.width, 2:2 + words]
    t.to_planes(x, out=out)
    assert torch.equal(out, torch.stack(t.to_planes(x)))
    untouched = torch.ones_like(buf, dtype=torch.bool)
    untouched[1:1 + t.width, 2:2 + words] = False
    assert (buf[untouched] == 7).all()
    with pytest.raises(ValueError):
        t.to_planes(x, out=buf[1:1 + t.width, :words + 1])


@pytest.mark.parametrize("t", [bp.F32, bp.BF16, bp.fixed(7), bp.fixed(8), bp.fixed(32)],
                         ids=lambda t: t.name)
def test_from_planes_reads_a_strided_view_of_a_padded_buffer(t):
    n = 1000
    x = t.cast(_rows(torch.float32 if t.kind != "fixed" else torch.int32, n, seed=2))
    padded = torch.zeros((t.width + 1, 256), dtype=torch.int32)
    view = padded[1:, :bp.num_words(n)]
    t.to_planes(x, out=view)
    got = t.from_planes(view, n)
    want = t.from_planes(t.to_planes(x), n)
    assert got.dtype == want.dtype and torch.equal(got.view(torch.int8), want.view(torch.int8))
    if t.kind == "fixed":  # the rows wrapped to nbits, sign-extended
        v = x.numpy().astype(np.int64) & ((1 << t.nbits) - 1)
        np.testing.assert_array_equal(got.numpy(), v - ((v >> (t.nbits - 1)) << t.nbits))


def test_frontend_cpu_results_match_numpy():
    """f32 and int8 MACs and a 16-bit subtract on the CPU against NumPy."""
    rng = np.random.default_rng(3)
    n = 1000
    x, y, z = (_rows(torch.float32, n, seed=s).numpy() for s in (4, 5, 6))
    mac = pim.compile(lambda a, b, c: a * b + c, dtype=pim.f32)
    got = mac(x, y, z, device="cpu").numpy()
    with np.errstate(all="ignore"):
        want = x * y + z
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_array_equal(got[ok].view(np.uint32), want[ok].view(np.uint32))
    a, b, c = (rng.integers(-128, 128, n).astype(np.int8) for _ in range(3))
    got8 = pim.compile(lambda a, b, c: a * b + c, dtype=pim.int8)(a, b, c, device="cpu")
    np.testing.assert_array_equal(got8.numpy(), (a * b + c).astype(np.int32))
    p, q = (rng.integers(-2**15, 2**15, n).astype(np.int16) for _ in range(2))
    got16 = pim.compile(lambda a, b: a - b, dtype=pim.int16)(p, q, device="cpu")
    np.testing.assert_array_equal(got16.numpy(), (p - q).astype(np.int32))


# ---------------------------------------------------------------------------
# The kernels on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _same(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Bit for bit, on the CPU."""
    got, want = got.cpu(), want.cpu()
    return got.dtype == want.dtype and got.shape == want.shape and torch.equal(
        got.contiguous().view(torch.int8), want.contiguous().view(torch.int8))


@pytest.mark.gpu
@pytest.mark.parametrize("t,carrier", CASES, ids=CASE_IDS)
def test_pack_kernel_matches_the_plain_path(cuda, t, carrier):
    for n in CARD_SIZES:
        full = _rows(carrier, n + 1, seed=n)
        fulld = full.to(cuda)
        for x, xd in ((full[:n], fulld[:n]), (full[1:], fulld[1:])):  # 1: off 16 bytes
            want = torch.stack(t.to_planes(x))
            before = pim_bitplanes.LAUNCHES["bitplane_pack"]
            got = t.to_planes(xd)
            assert pim_bitplanes.LAUNCHES["bitplane_pack"] == before + 1
            assert _same(torch.stack(got), want), (t.name, carrier, n)
            out = torch.full((t.width + 1, bp.num_words(n) + 3), 9, dtype=torch.int32,
                             device=cuda)
            t.to_planes(xd, out=out[1:, 1:1 + bp.num_words(n)])
            assert _same(out[1:, 1:1 + bp.num_words(n)], want)
            assert (out[0] == 9).all() and (out[:, 0] == 9).all() and (out[:, -2:] == 9).all()


@pytest.mark.gpu
@pytest.mark.parametrize("t", FIXED + [bp.F32, bp.BF16], ids=lambda t: t.name)
def test_unpack_kernel_matches_the_plain_path(cuda, t):
    rng = np.random.default_rng(t.width)
    for n in CARD_SIZES:
        words = bp.num_words(n)
        padded = rng.integers(0, 2**32, (t.width + 1, words + 40), dtype=np.uint64)
        padded = torch.from_numpy(padded.astype(np.uint32).view(np.int32))
        view = padded[1:, 3:3 + words]
        want = t.from_planes(view, n)
        before = pim_bitplanes.LAUNCHES["bitplane_unpack"]
        got = t.from_planes(padded.to(cuda)[1:, 3:3 + words], n)
        assert pim_bitplanes.LAUNCHES["bitplane_unpack"] == before + 1
        assert _same(got, want), (t.name, n)
        assert _same(t.from_planes(list(padded.to(cuda)[1:, 3:3 + words]), n), want)


@pytest.mark.gpu
@pytest.mark.parametrize("t", [bp.F32, bp.BF16], ids=lambda t: t.name)
def test_float_specials_round_trip_on_the_card(cuda, t):
    """NaNs with payloads, infinities, -0 and subnormals pack as the plain
    path packs them, and come back bit for bit."""
    x = torch.from_numpy(np.concatenate([F32_SPECIALS, NAN_BITS.view(np.float32)]))
    for rows in (x, x.to(torch.bfloat16)) if t.kind == "bf16" else (x,):
        want = torch.stack(t.to_planes(rows))
        got = t.to_planes(rows.to(cuda))
        assert _same(torch.stack(got), want)
        assert _same(t.from_planes(got, len(rows)), t.from_planes(want, len(rows)))
    if t.kind == "float32":
        assert _same(t.from_planes(t.to_planes(x.to(cuda)), len(x)), x)


@pytest.mark.gpu
def test_kernel_counters_step_once_an_argument_and_an_output(cuda):
    mac = pim.compile(lambda a, b, c: a * b + c, dtype=pim.f32)
    args = [_rows(torch.float32, 5000, seed=s) for s in range(3)]
    mac(*args, device="cpu")
    pim_bitplanes.reset_launches()
    mac(*args, device="cpu")
    assert dict(pim_bitplanes.LAUNCHES) == {"bitplane_pack": 0, "bitplane_unpack": 0}
    got = mac(*(a.to(cuda) for a in args))
    torch.cuda.synchronize()
    assert dict(pim_bitplanes.LAUNCHES) == {"bitplane_pack": 3, "bitplane_unpack": 1}
    assert _same(got, mac(*args, device="cpu"))
    pim_bitplanes.reset_launches()
