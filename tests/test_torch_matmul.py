"""The port's matmul on the CPU against the JAX reference: the plain
version and ``ops.pim_matmul_op(device="cpu")`` equal the reference Pallas
kernel (interpret mode) and ``ref.matmul_ref`` within the reference's own
tolerances, and the port accepts and refuses exactly the shapes the
reference accepts and refuses.  The kernel variant the card would run is
planned here too: by Fig 5 size and type, ``general`` for ragged shapes,
never the tensor cores for float32."""

import itertools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro_torch.kernels import ops, pim_matmul, ref

# The reference's sweep (tests/test_kernels.py) plus ragged dims that the
# reference's clipped blocks accept.
SHAPES = [(1, 128, 128, 128), (2, 256, 384, 512), (3, 128, 256, 128), (1, 33, 17, 65)]
# dtype -> (jax dtype, torch dtype, rtol); atol is 8 x rtol, as in the reference.
DTYPES = {"f32": (jnp.float32, torch.float32, 2e-4),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(a_shape, b_shape, dtype: str, seed: int):
    """numpy float32 operands; for bf16, values exactly representable in
    bf16, so neither package rounds its inputs."""
    rng = np.random.default_rng(seed)
    out = []
    for shape in (a_shape, b_shape):
        x = rng.normal(size=shape).astype(np.float32)
        if dtype == "bf16":
            x = (x.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)
        out.append(x)
    return out


def _both(x: np.ndarray, dtype: str):
    jdt, tdt, _ = DTYPES[dtype]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _close(got: torch.Tensor, want, dtype: str):
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol * 8)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_matmul_matches_reference(shape, dtype):
    G, M, K, N = shape
    a, b = _inputs((G, M, K), (G, K, N), dtype, seed=sum(shape))
    (ja, ta), (jb, tb) = _both(a, dtype), _both(b, dtype)
    want_kernel = ref_ops.pim_matmul_op(ja, jb)
    want_ref = ref_ref.matmul_ref(ja, jb)
    before = sum(pim_matmul.LAUNCHES.values())
    got_op = ops.pim_matmul_op(ta, tb, device="cpu")
    got_plain = pim_matmul.matmul_plain(ta, tb)
    got_ref = ref.matmul_ref(ta, tb)
    assert sum(pim_matmul.LAUNCHES.values()) == before  # CPU: no kernel launch
    for got in (got_op, got_plain, got_ref):
        assert got.shape == (G, M, N) and got.dtype == DTYPES[dtype][1]
        _close(got, want_kernel, dtype)
        _close(got, want_ref, dtype)


@pytest.mark.parametrize("blocks", [(128, 128, 128), (64, 128, 256)])
def test_matmul_block_shapes_match_reference(blocks):
    bm, bk, bn = blocks
    a, b = _inputs((1, 256, 256), (1, 256, 256), "f32", seed=1)
    want = ref_ops.pim_matmul_op(jnp.asarray(a), jnp.asarray(b), bm=bm, bk=bk, bn=bn)
    got = ops.pim_matmul_op(a, b, bm=bm, bk=bk, bn=bn, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=1e-3)


# (a shape, b shape, blocks): the first three are accepted by the reference,
# the rest refused.
ACCEPTED = [((1, 33, 17), (1, 17, 65), {}), ((2, 256, 384), (2, 384, 512), {}),
            ((1, 192, 96), (1, 96, 64), dict(bm=64, bk=32, bn=64))]
REFUSED = [((1, 200, 128), (1, 128, 128), {}), ((1, 128, 200), (1, 200, 128), {}),
           ((1, 128, 128), (1, 128, 200), {}), ((2, 128, 128), (1, 128, 128), {}),
           ((1, 128, 64), (1, 128, 128), {}), ((1, 256, 256), (1, 256, 256), dict(bm=96)),
           ((1, 128, 384), (1, 384, 128), dict(bk=256))]


@pytest.mark.parametrize("a_shape,b_shape,blocks", ACCEPTED + REFUSED)
def test_matmul_accepts_and_refuses_what_the_reference_does(a_shape, b_shape, blocks):
    a, b = _inputs(a_shape, b_shape, "f32", seed=2)
    try:
        ref_ops.pim_matmul_op(jnp.asarray(a), jnp.asarray(b), **blocks)
        ref_ok = True
    except AssertionError:
        ref_ok = False
    assert ref_ok == ((a_shape, b_shape, blocks) in ACCEPTED)
    if ref_ok:
        assert ops.pim_matmul_op(a, b, device="cpu", **blocks).shape == (
            a_shape[0], a_shape[1], b_shape[2])
    else:
        with pytest.raises(ValueError):
            ops.pim_matmul_op(a, b, device="cpu", **blocks)


def test_matmul_refuses_mixed_dtypes_and_other_ranks():
    a = torch.ones((1, 16, 16))
    with pytest.raises(ValueError, match="float32 or two bfloat16"):
        pim_matmul.matmul(a, a.to(torch.bfloat16))
    with pytest.raises(ValueError, match="float32 or two bfloat16"):
        pim_matmul.matmul(a.double(), a.double())
    with pytest.raises(ValueError, match="3-D"):
        pim_matmul.matmul(a[0], a[0])


def test_matmul_without_a_card_raises(monkeypatch):
    """No CPU fallback: without ``device="cpu"`` the call needs a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = np.ones((1, 16, 16), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.pim_matmul_op(a, a)


FIG5_PLAN = {torch.float32: {16: "f32_small", 32: "f32_small", 64: "f32_small",
                             128: "f32_simt128", 256: "f32_simt128", 512: "f32_simt128"},
             torch.bfloat16: {16: "bf16_mma", 32: "bf16_mma", 64: "bf16_wgmma64",
                              128: "bf16_wgmma128", 256: "bf16_wgmma128",
                              512: "bf16_wgmma128"}}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [16, 32, 64, 128, 256, 512])
def test_plan_picks_the_variant_for_each_fig5_size(n, dtype):
    assert pim_matmul.plan(2**26 // n**2, n, n, n, dtype) == FIG5_PLAN[dtype][n]
    assert pim_matmul.plan(2, n, n, n, dtype) == FIG5_PLAN[dtype][n]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 33, 17, 65), (2, 17, 100, 9), (1, 192, 96, 64),
                                   (3, 16, 16, 32), (1, 48, 48, 48), (1, 64, 32, 64)])
def test_plan_gives_ragged_shapes_the_general_variant(shape, dtype):
    assert pim_matmul.plan(*shape, dtype) == "general"


def test_plan_never_puts_float32_on_the_tensor_cores():
    dims = (8, 16, 17, 32, 33, 64, 96, 128, 192, 256, 384, 512)
    seen = set()
    for m, k, n in itertools.product(dims, repeat=3):
        f32 = pim_matmul.plan(3, m, k, n, torch.float32)
        bf = pim_matmul.plan(3, m, k, n, torch.bfloat16)
        assert f32 not in pim_matmul.TENSOR_CORE_VARIANTS
        assert f32.startswith("f32_") or f32 == "general"
        assert bf.startswith("bf16_") or bf == "general"
        if bf.startswith("bf16_wgmma"):  # what the TMA-fed kernel requires
            tile = 128 if bf == "bf16_wgmma128" else 64
            assert m % tile == 0 and n % tile == 0 and k % 64 == 0
        seen |= {f32, bf}
    assert seen == set(pim_matmul.VARIANTS)


def test_variant_numbering_matches_the_kernel_source():
    enum = re.search(r"enum Variant \{([^}]*)\}", pim_matmul.SOURCE.read_text()).group(1)
    numbers = {name.strip().lower(): int(v) for name, v in re.findall(r"(\w+) = (\d+)", enum)}
    assert numbers == {name: i for i, name in enumerate(pim_matmul.VARIANTS)}


def test_each_variant_has_its_kernel_in_the_source():
    """``kernel_symbol`` names a ``__global__`` kernel of the source for each
    variant (the card run reads registers and SASS by that name)."""
    kernels = re.findall(r"__global__ void (?:__launch_bounds__\([^)]*\) )?(\w+)\(",
                         pim_matmul.SOURCE.read_text())
    assert sorted(kernels) == sorted(pim_matmul.kernel_symbol(v) for v in pim_matmul.VARIANTS)
