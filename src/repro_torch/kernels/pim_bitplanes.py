"""Bit-plane packing and unpacking on the card: ``csrc/bitplanes.cu``.

Two kernels written by hand, the same 32 x 32 bit transpose each way:
``bitplane_pack_kernel`` turns ``n`` rows of a 1-, 2- or 4-byte integer
carrier into ``nbits`` planes (bit ``r % 32`` of word ``r // 32`` of plane
``j`` is bit ``j`` of row ``r``, the tail of the last word zero), and
``bitplane_unpack_kernel`` turns planes back into ``n`` int32 rows.
``core/bitplanes.py``'s ``PimType.to_planes`` / ``from_planes`` call them
for CUDA tensors; their plain PyTorch versions are the ``int_to_planes`` /
``planes_to_int`` arithmetic there, which CPU tensors take.  Each launch
is counted: ``pack.launches.bitplane_pack`` and
``pack.launches.bitplane_unpack`` (:data:`LAUNCHES`).

The library is built in one ``nvcc`` round with the loop kernel's
(``pim_bitserial.build_jobs``), since every f32 call needs both.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.core import spans

from . import _build

SOURCE = Path(__file__).with_name("csrc") / "bitplanes.cu"
# Row carriers the kernel reads as they are (sign-extended as ``.to(torch.int32)``).
CARRIERS = (torch.int8, torch.int16, torch.int32)

LAUNCHES = spans.CounterView({k: f"pack.launches.{k}"
                              for k in ("bitplane_pack", "bitplane_unpack")})


def reset_launches() -> None:
    spans.reset_counters("pack.launches.")


def build_job() -> tuple[str, str]:
    return ("bitplanes", SOURCE.read_text())


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from . import pim_bitserial  # it imports this module

    _build.build(pim_bitserial.build_jobs())
    lib = _build.load(*build_job())
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.bitplane_pack_launch.argtypes = [p, i, ll, i, p, ll, p]
    lib.bitplane_pack_launch.restype = ctypes.c_int
    lib.bitplane_unpack_launch.argtypes = [p, ll, ll, i, i, p, p]
    lib.bitplane_unpack_launch.restype = ctypes.c_int
    lib.bitplane_error_string.argtypes = [ctypes.c_int]
    lib.bitplane_error_string.restype = ctypes.c_char_p
    return lib


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.bitplane_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")


def _planes_ok(planes: torch.Tensor, rows: int, words: int, device) -> bool:
    return (planes.dtype == torch.int32 and planes.device == device and planes.dim() == 2
            and planes.shape[0] == rows and (planes.stride(1) == 1 or planes.shape[1] <= 1))


def pack(x: torch.Tensor, nbits: int, out: torch.Tensor | None = None) -> torch.Tensor:
    """``nbits`` planes of the CUDA rows ``x`` (``[n]``, int8, int16 or int32)
    into ``out`` (``[nbits, ceil(n / 32)]`` int32, any row stride; allocated
    when None), which is returned."""
    if x.device.type != "cuda" or x.dim() != 1 or x.dtype not in CARRIERS:
        raise ValueError(f"pack takes a 1-D CUDA tensor of {CARRIERS}, got "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if not 1 <= nbits <= 32:
        raise ValueError(f"nbits must lie in 1..32, got {nbits}")
    n = x.shape[0]
    words = (n + 31) // 32
    if out is None:
        out = torch.empty((nbits, words), dtype=torch.int32, device=x.device)
    elif not _planes_ok(out, nbits, words, x.device) or out.shape[1] != words:
        raise ValueError(f"out must be int32 [{nbits}, {words}] on {x.device} with "
                         f"unit column stride, got {out.dtype} {tuple(out.shape)} "
                         f"stride {out.stride()} on {out.device}")
    if n == 0:
        return out
    x = x.contiguous()
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.bitplane_pack_launch(x.data_ptr(), x.element_size(), n, nbits,
                                   out.data_ptr(), out.stride(0), stream)
    _check(lib, err, "bitplane_pack launch")
    spans.count("pack.launches.bitplane_pack")
    return out


def unpack(planes: torch.Tensor, n: int, nbits: int, signed: bool,
           out: torch.Tensor | None = None) -> torch.Tensor:
    """``n`` int32 rows from the CUDA planes ``planes`` (``[nbits, >=
    ceil(n / 32)]`` int32, any row stride): the bits as they are, or
    sign-extended from ``nbits`` when ``signed``.  Written into ``out``
    (``[n]`` int32, contiguous; allocated when None), which is returned."""
    device = planes.device
    words = (n + 31) // 32
    if device.type != "cuda" or not _planes_ok(planes, nbits, words, device) \
            or planes.shape[1] < words:
        raise ValueError(f"unpack takes CUDA int32 planes [{nbits}, >= {words}] with "
                         f"unit column stride, got {planes.dtype} {tuple(planes.shape)} "
                         f"stride {planes.stride()} on {device}")
    if not 1 <= nbits <= 32:
        raise ValueError(f"nbits must lie in 1..32, got {nbits}")
    if out is None:
        out = torch.empty((n,), dtype=torch.int32, device=device)
    elif (out.dtype != torch.int32 or out.device != device or out.shape != (n,)
          or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous int32 [{n}] on {device}, got "
                         f"{out.dtype} {tuple(out.shape)} on {out.device}")
    if n == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.bitplane_unpack_launch(planes.data_ptr(), planes.stride(0), n, nbits,
                                     int(signed), out.data_ptr(), stream)
    _check(lib, err, "bitplane_unpack launch")
    spans.count("pack.launches.bitplane_unpack")
    return out
