"""The port's matmul on the CPU against the JAX reference: the plain
version and ``ops.pim_matmul_op(device="cpu")`` equal the reference Pallas
kernel (interpret mode) and ``ref.matmul_ref`` within the reference's own
tolerances, and the port accepts and refuses exactly the shapes the
reference accepts and refuses."""

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
    before = pim_matmul.LAUNCHES["pim_matmul"]
    got_op = ops.pim_matmul_op(ta, tb, device="cpu")
    got_plain = pim_matmul.matmul_plain(ta, tb)
    got_ref = ref.matmul_ref(ta, tb)
    assert pim_matmul.LAUNCHES["pim_matmul"] == before  # CPU: no kernel launch
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
