"""Executor-mode shootout on the PyTorch/CUDA port: the straight-line kernel
against the loop kernel.

Races the ``cuda-unrolled`` kernel (straight-line CUDA generated per
schedule, wave chunks on register columns) against the ``cuda-loop`` kernel
(``csrc/bitserial_loop.cu``, one packed gate table walked in hazard-free
groups) and the ``interpreter`` (one PyTorch op per gate) on fused MAC
programs, reporting per mode the schedule shape the compiler produced —
gates, peak columns after the ``reorder`` pass, dependency waves — next to
the time per dispatch (``torch_common.time_fn``: CUDA events around each
call on the card, median of ``ITERS`` after one warm-up; at 4096 elements
one straight-line f32 MAC is 13 launches of a single block, and medians of
3 calls spread from 0.36 to 0.97 ms across H100 runs, PERF.md).  This is the perf gate of
``benchmarks/torch_smoke.py``: the straight-line kernel must beat the loop
kernel on the f32 fused MAC.  ``benchmarks/torch_run.py --json PATH`` writes
the rows as JSON.

The first ``cuda-unrolled`` dispatch of a schedule builds its kernel with
``nvcc`` (seconds for the 13-segment f32 MAC).  So every mode runs once,
untimed, before any is timed, and no timed call follows seconds of an idle
card: timed right after its build, the straight-line f32 MAC at 4096
elements read 0.97 ms on an H100, against 0.57 – 0.63 ms with its kernel
built beforehand (PERF.md).  ``us_per_call`` times the steady state.  ``--elems`` sets the elements per
dispatch (default 4096, the reference's; the packed words are 1/32 of it).
On the CPU (``--device cpu``) each mode runs its plain PyTorch version, so
the times say nothing of the kernels.

    PYTHONPATH=src python -m benchmarks.torch_exec_modes [--elems 16777216]
"""

from __future__ import annotations

import numpy as np
import torch

import repro_torch.pim as pim
from repro_torch.core import ir
from repro_torch.kernels import pim_bitserial
from repro_torch.pim.frontend import resolve_device

from .torch_common import bases_from_args, emit, make_parser, passes_from_args, time_fn

N_ELEMS = 4096
ITERS = 10

_MODES = ("interpreter", "cuda-loop", "cuda-unrolled")

# dtype rows: f32 is the gated case; int8 shows the auto threshold picking
# `unrolled` on its own.
_CASES = {"f32_mac": pim.f32, "int8_mac": pim.int8}


def _planes(mac, dtype, rng, elems: int, device) -> torch.Tensor:
    if dtype.kind == "fixed":
        lo, hi = -(2 ** (dtype.nbits - 1)), 2 ** (dtype.nbits - 1)
        arrays = [rng.integers(lo, hi, elems).astype(np.int32) for _ in range(3)]
    else:
        arrays = [rng.standard_normal(elems).astype(np.float32) for _ in range(3)]
    return torch.stack([p for t, x in zip(mac.in_types, arrays)
                        for p in t.to_planes(t.cast(x, device))])


def run(bases: tuple[str, ...] = ("memristive",),
        passes: tuple[str, ...] | None = None, device=None,
        elems: int = N_ELEMS) -> list[dict]:
    device = resolve_device(device)
    passes = ir.DEFAULT_PASSES if passes is None else passes
    rng = np.random.default_rng(0)
    rows = []
    for name, dtype in _CASES.items():
        mac = pim.compile(lambda a, b, c: a * b + c, dtype=dtype)
        # Time the executor dispatch alone, on pre-packed planes — plane
        # pack/unpack is shared by every mode and would otherwise drown the
        # kernel difference.
        planes = _planes(mac, dtype, rng, elems, device)
        for basis in bases:
            compiled = mac.compiled(basis=basis, passes=passes)
            backends = [ir.get_backend(mode) for mode in _MODES]
            for backend in backends:  # builds and uploads, untimed
                backend.run(compiled, planes)
            for mode, backend in zip(_MODES, backends):
                us = time_fn(
                    lambda backend=backend, c=compiled: backend.run(c, planes).planes,
                    device=device, warmup=1, iters=ITERS)
                rows.append({
                    "name": f"exec/{name}/{basis}/{mode}",
                    "us_per_call": f"{us:.0f}",
                    "gates": compiled.num_gates,
                    "num_cols": compiled.num_cols,
                    "waves": compiled.num_waves,
                    "auto_mode": pim_bitserial.resolve_mode(compiled),
                })
    return rows


def add_elems_flag(parser):
    parser.add_argument("--elems", type=int, default=N_ELEMS,
                        help=f"elements per dispatch (default {N_ELEMS})")
    return parser


def main(argv=None):
    args = add_elems_flag(make_parser()).parse_args(argv)
    emit(run(bases=bases_from_args(args), passes=passes_from_args(args),
             device=args.device, elems=args.elems))


if __name__ == "__main__":
    main()
