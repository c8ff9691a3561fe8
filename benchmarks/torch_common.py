"""Shared utilities of the PyTorch/CUDA port's benchmarks: timing, CSV
emission and the common CLI.  Imports no JAX.

Every ``benchmarks/torch_*`` figure accepts the same flags:

  --basis {memristive,dram,both}   which logic basis' columns to emit
  --passes fold,cse,fuse,cse,dce   override the IR pass pipeline (empty
                                   string = raw, no optimization passes)
  --device cuda|cpu                where to run (default: the CUDA card;
                                   with no card the run fails)

``run_cli(run)`` parses them and calls ``run(bases=..., passes=...,
device=...)``.

    PYTHONPATH=src python -m benchmarks.torch_fig5_matmul --device cpu
"""

from __future__ import annotations

import argparse
import time

import torch

BASES = ("memristive", "dram")


def make_parser() -> argparse.ArgumentParser:
    """The common flags; a benchmark may add its own before parsing."""
    p = argparse.ArgumentParser(description="ConvPIM benchmark (PyTorch/CUDA port)")
    p.add_argument("--basis", choices=(*BASES, "both"), default="both",
                   help="logic basis to report (default: both)")
    p.add_argument("--passes", default=None, metavar="P1,P2,...",
                   help="comma-separated IR pass list overriding the default "
                        "pipeline; pass an empty string for no passes")
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: the CUDA card)")
    return p


def passes_from_args(args) -> tuple[str, ...] | None:
    """``--passes`` as a pass tuple, or None to keep the default pipeline."""
    if args.passes is None:
        return None
    return tuple(p for p in args.passes.split(",") if p)


def bases_from_args(args) -> tuple[str, ...]:
    return BASES if args.basis == "both" else (args.basis,)


def run_cli(run_fn, argv=None) -> None:
    """Shared benchmark main: parse the common flags, run, emit CSV."""
    args = make_parser().parse_args(argv)
    emit(run_fn(bases=bases_from_args(args), passes=passes_from_args(args),
                device=args.device))


def time_fn(fn, *args, device: torch.device, warmup: int = 1,
            iters: int = 3) -> float:
    """Median time per call of ``fn(*args)`` in microseconds: CUDA events
    around each call on a CUDA ``device``, the host clock on the CPU.  The
    device is synchronised after the warm-up and after every timed call."""
    if iters < 1:
        raise ValueError("iters must be at least 1")
    device = torch.device(device)
    cuda = device.type == "cuda"
    for _ in range(warmup):
        fn(*args)
    if cuda:
        torch.cuda.synchronize(device)
    ts = []
    for _ in range(iters):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) * 1e-3)
        else:
            t0 = time.perf_counter()
            fn(*args)
            ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2] * 1e6


def emit(rows: list[dict]) -> None:
    """Print ``name,us_per_call,derived`` CSV (harness convention)."""
    for r in rows:
        name = r.pop("name")
        us = r.pop("us_per_call", "")
        derived = ";".join(f"{k}={v}" for k, v in r.items())
        print(f"{name},{us},{derived}")
