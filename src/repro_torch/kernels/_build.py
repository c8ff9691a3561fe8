"""Build CUDA sources into shared libraries with ``nvcc`` and load them with
``ctypes``.

Each source is compiled on its own, for ``sm_90a``, into a library with a
plain C interface (no PyTorch headers, so a build takes seconds, not
minutes).  Libraries land in ``build/kernels/`` at the repository root,
named by a hash of the source text and flags, so a changed source never
loads a stale library.  :func:`build` starts one ``nvcc`` per missing
library, all at once.  ``-Xptxas -v`` output (registers, shared memory,
spills) is kept in :data:`BUILD_LOG` for reports.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# library file name -> {"name", "seconds", "ptxas": {kernel: {...}}, "log"}
BUILD_LOG: dict[str, dict] = {}
_LOADED: dict[Path, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda/bin/nvcc``
    or ``nvcc`` on ``PATH``."""
    candidates = [os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"]
    for home in candidates:
        path = Path(home) / "bin" / "nvcc"
        if home and path.is_file():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def library_path(name: str, source: str) -> Path:
    digest = hashlib.sha1(
        (source + "\0" + " ".join(NVCC_FLAGS)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def parse_ptxas(log: str) -> dict[str, dict[str, int]]:
    """Per-kernel registers and spill bytes from ``-Xptxas -v`` output."""
    info: dict[str, dict[str, int]] = {}
    current = None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            current = info.setdefault(m.group(1), {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and current is not None:
            current["spill_stores"] = int(m.group(1))
            current["spill_loads"] = int(m.group(2))
            continue
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current = info.setdefault(m.group(1), {})
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and current is not None:
            current["registers"] = int(m.group(1))
    return info


def build(jobs: list[tuple[str, str]]) -> list[Path]:
    """Compile each ``(name, source)`` whose library is missing, one ``nvcc``
    process per source, all started together.  Returns the library paths in
    job order; raises ``RuntimeError`` with the compiler output if any
    build fails."""
    paths = [library_path(name, src) for name, src in jobs]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for (name, src), path in zip(jobs, paths):
        if path.exists() or any(path == p for _, p, _, _ in running):
            continue
        cu = path.with_suffix(".cu")
        cu.write_text(src)
        tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(cu)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((name, path, tmp, (proc, time.perf_counter())))
    failures = []
    for name, path, tmp, (proc, t0) in running:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{name} ({path.name}):\n{log}")
            continue
        os.replace(tmp, path)
        BUILD_LOG[path.name] = {"name": name, "seconds": seconds,
                                "ptxas": parse_ptxas(log), "log": log}
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return paths


def load(name: str, source: str) -> ctypes.CDLL:
    """Build ``source`` if needed and load its library (cached per path)."""
    path = build([(name, source)])[0]
    lib = _LOADED.get(path)
    if lib is None:
        lib = _LOADED[path] = ctypes.CDLL(str(path))
    return lib
