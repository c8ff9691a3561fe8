"""Run one cell of the benchmark and print its result line.

    python3 pimbench/run.py --workload memristive.f32_bulk --seed 7 --seconds 10 --trace 0

Prints the checks compared beside their limits as the last lines on
standard error, and one JSON object as the last line of standard output.
Exits non-zero, with no result, without enough CUDA devices, when the port
cannot be imported, or when JAX or the JAX package was loaded.
``--control 1`` puts the lower-precision control in the program's place
(to show that the check fails it); the benchmark's own runs never pass it.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# Build and kernel caches at fixed paths inside the checkout.
CACHE_ENV = {
    "TORCH_EXTENSIONS_DIR": ROOT / "build" / "torch_extensions",
    "TRITON_CACHE_DIR": ROOT / "build" / "triton_cache",
    "CUDA_CACHE_PATH": ROOT / "build" / "cuda_cache",
}
# Top-level module names that must not be loaded by the end of a run.
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def forbidden_modules(modules=None) -> list[str]:
    """The forbidden top-level names among ``modules`` (``sys.modules``)."""
    names = sys.modules if modules is None else modules
    return sorted({name.split(".", 1)[0] for name in names} & FORBIDDEN)


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"not read ({exc})"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    for key, path in CACHE_ENV.items():
        os.environ[key] = str(path)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch

    from pimbench import harness, spec

    chips = spec.load_cell(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    result, checks = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                      t_start=T_START, control=bool(args.control))
    found = forbidden_modules()
    if found:
        print(f"loaded by the end of the run: {', '.join(found)}", file=sys.stderr)
        return 3
    print(f"card and power limit: {power_limit()}", file=sys.stderr)
    for line in checks:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
