"""MatPIM-style batched matmul (paper §4, ref [9]) with a CUDA kernel for
Hopper.

MatPIM expresses matrix multiplication as a serial sequence of vectored
(row-parallel) operations: for each k, a rank-1 update C += A[:,k] ⊗ B[k,:]
executes element-parallel across all crossbar rows.  The reference's
TPU kernel (``src/repro/kernels/pim_matmul.py:31 _mm_kernel``) keeps that
blocked, serially accumulated structure around the matrix unit; this port
keeps its contract — a float32 accumulator over K, one rounding to the
input type at the end — in hand-written CUDA kernels
(``csrc/pim_matmul.cu``), one per variant:

* ``bf16_wgmma128`` / ``bf16_wgmma64``: bfloat16 on the tensor cores
  (``wgmma`` fed by TMA), 128×128 or 64×64 output tiles;
* ``bf16_mma``: bfloat16 matrices of 16 or 32 (``mma.sync``, a warp per
  batch entry);
* ``f32_simt128``: float32 at the FP32-bound sizes, 128×128 tiles;
* ``f32_small``: float32 matrices of 16, 32 or 64, many entries a block;
* ``general``: every other accepted shape (ragged dims), both types.

:func:`plan` picks the variant from the shape and type before the launch;
a variant never stands in for another that failed.

:func:`matmul` takes ``[G, M, K] @ [G, K, N]`` in float32 or bfloat16 and
accepts and refuses the same shapes as the reference: blocks ``bm/bk/bn``
are clipped to the dims and each must divide its dim.  The blocks only
validate the call and set the plain version's K step.  A CUDA tensor
launches the planned variant (one launch, counted under its name in
:data:`LAUNCHES`); a CPU tensor runs :func:`matmul_plain`.  The PIM cost
model for the same operation (gate-level, bit-serial) comes from
``repro_torch.core`` — benchmarks compare the two.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.core import spans

from . import _build

DEFAULT_BM = 128
DEFAULT_BK = 128
DEFAULT_BN = 128

SOURCE = Path(__file__).with_name("csrc") / "pim_matmul.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# Kernel variants, in the numbering of the C launcher: each name ``v`` runs
# the kernel ``mm_<v>`` of the library, on the tensor cores where True.
VARIANTS = {"general": False, "f32_small": False, "f32_simt128": False,
            "bf16_mma": True, "bf16_wgmma64": True, "bf16_wgmma128": True}
TENSOR_CORE_VARIANTS = tuple(v for v, tensor_cores in VARIANTS.items() if tensor_cores)

# Kernel launches on CUDA tensors, one per launch, by variant: the counters
# ``exec.launches.mm_<variant>`` of :mod:`repro_torch.core.spans`.
LAUNCHES = spans.CounterView({v: f"exec.launches.mm_{v}" for v in VARIANTS})


def reset_launches() -> None:
    spans.reset_counters("exec.launches.mm_")


def plan(G: int, M: int, K: int, N: int, dtype: torch.dtype) -> str:
    """The kernel variant for a ``[G, M, K] @ [G, K, N]`` call, by shape and
    type: the tensor cores only for bfloat16, ``general`` for any shape the
    others do not take."""
    square = M == K == N
    if dtype == torch.bfloat16:
        if square and M in (16, 32):
            return "bf16_mma"
        if K % 64 == 0 and M % 128 == 0 and N % 128 == 0:
            return "bf16_wgmma128"
        if K % 64 == 0 and M % 64 == 0 and N % 64 == 0:
            return "bf16_wgmma64"
        return "general"
    if square and M in (16, 32, 64):
        return "f32_small"
    if M % 128 == 0 and N % 128 == 0 and K % 8 == 0:
        return "f32_simt128"
    return "general"


def check_shapes(a: torch.Tensor, b: torch.Tensor, bm: int, bk: int,
                 bn: int) -> tuple[int, int, int]:
    """Validate a ``[G, M, K] @ [G, K, N]`` call as the reference does and
    return the blocks clipped to the dims.  Raises ``ValueError`` where the
    reference asserts, and for what the kernel does not take."""
    if a.dim() != 3 or b.dim() != 3:
        raise ValueError(f"matmul takes 3-D [G,M,K] and [G,K,N] tensors, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in _DTYPE_CODES:
        raise ValueError(f"matmul takes two float32 or two bfloat16 tensors, "
                         f"got {a.dtype} and {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"operands on different devices: {a.device}, {b.device}")
    G, M, K = a.shape
    G2, K2, N = b.shape
    if G != G2 or K != K2:
        raise ValueError(f"mismatched shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if min(G, M, K, N) < 1:
        raise ValueError(f"empty dimension in {tuple(a.shape)} @ {tuple(b.shape)}")
    bm, bk, bn = min(bm, M), min(bk, K), min(bn, N)
    if M % bm or K % bk or N % bn:
        raise ValueError(f"blocks (bm={bm}, bk={bk}, bn={bn}) do not divide "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    return bm, bk, bn


def matmul_plain(a: torch.Tensor, b: torch.Tensor, *,
                 bk: int = DEFAULT_BK) -> torch.Tensor:
    """Plain version of the kernel, in the reference kernel's accumulation
    order: a float32 ``[G, M, N]`` accumulator gains
    ``a_blk.float() @ b_blk.float()`` for each K block of ``bk``, then is
    cast once to ``a.dtype``."""
    G, M, K = a.shape
    acc = torch.zeros((G, M, b.shape[2]), dtype=torch.float32, device=a.device)
    for k0 in range(0, K, bk):
        acc += a[:, :, k0:k0 + bk].float() @ b[:, k0:k0 + bk, :].float()
    return acc.to(a.dtype)


def build_job() -> tuple[str, str]:
    """The kernel's ``(name, source)`` build job for ``_build.build``."""
    return "pim_matmul", SOURCE.read_text()


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(*build_job())
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pim_matmul_launch.argtypes = [p, p, p, i, i, ctypes.c_longlong, i, i, i, p]
    lib.pim_matmul_launch.restype = ctypes.c_int
    lib.pim_matmul_error_string.argtypes = [ctypes.c_int]
    lib.pim_matmul_error_string.restype = ctypes.c_char_p
    return lib


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous at a 16-byte-aligned address (the kernels' vector
    loads and tensor maps need it)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def kernel_symbol(variant: str) -> str:
    """The name of ``variant``'s kernel in the library (templates add their
    arguments after it in the mangled symbol)."""
    return f"mm_{variant}"


def _launch(a: torch.Tensor, b: torch.Tensor, variant: str) -> torch.Tensor:
    """Launch ``variant`` on CUDA operands of a checked shape; raises where
    the variant does not take the shape (``general`` takes every one)."""
    G, M, K = a.shape
    N = b.shape[2]
    if max(M, K, N) >= 2**31:
        raise ValueError(f"matrix dims must be below 2^31, got M={M} K={K} N={N}")
    a, b = _aligned(a), _aligned(b)
    out = torch.empty((G, M, N), dtype=a.dtype, device=a.device)
    lib = _lib()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = lib.pim_matmul_launch(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                _DTYPE_CODES[a.dtype], list(VARIANTS).index(variant),
                                G, M, K, N, stream)
    if err != 0:
        msg = lib.pim_matmul_error_string(err).decode()
        raise RuntimeError(f"pim_matmul {variant} launch for {tuple(a.shape)} @ "
                           f"{tuple(b.shape)} failed: CUDA error {err} ({msg})")
    spans.count(f"exec.launches.mm_{variant}")
    return out


def matmul(a: torch.Tensor, b: torch.Tensor, *, bm: int = DEFAULT_BM,
           bk: int = DEFAULT_BK, bn: int = DEFAULT_BN) -> torch.Tensor:
    """Batched matmul ``[G, M, K] @ [G, K, N] -> [G, M, N]`` (float32
    accumulate, one rounding to ``a.dtype``).  CUDA tensors launch the
    variant :func:`plan` picks; CPU tensors run :func:`matmul_plain`."""
    _, bk, _ = check_shapes(a, b, bm, bk, bn)
    if a.device.type == "cuda":
        return _launch(a, b, plan(*a.shape, b.shape[2], a.dtype))
    if a.device.type == "cpu":
        return matmul_plain(a, b, bk=bk)
    raise ValueError(f"no matmul for device {a.device}")
