"""Two design choices of the loop kernel (``csrc/bitserial_loop.cu``),
each timed against the kernel as it ships, on the card:

* ``switch``: each gate dispatches on its opcode and loads only the
  operands that opcode reads (NOR two, NOT and COPY one, INIT none), in
  place of the shipped branch-free ``MAJ3(a, b, c) ^ invert`` over three
  loads, two of which may name the constant columns.  Same gate table.
* ``groups1``: the shipped kernel on a table cut into groups of one gate,
  so no two gates' loads are issued together (the shipped table groups up
  to ``GATE_GROUP`` hazard-free gates).

Runs the f32 MAC ``a*b+c`` on both bases at 2^24 elements (2^19 packed
words), holds every version's output against the plain version word for
word, and times each with CUDA events (mean of 20 launches after a
warm-up) in the order shipped, switch, groups1, groups1, switch, shipped.

    PYTHONPATH=src python -m benchmarks.torch_loop_probe
"""

from __future__ import annotations

import ctypes
import re
import subprocess

import numpy as np
import torch

import repro_torch.pim as pim
from repro_torch.kernels import _build
from repro_torch.kernels import pim_bitserial as pb

WORDS = 1 << 19
REPS = 20

# run_group with a dispatch on the opcode (pim_bitserial's OP_* numbering:
# NOR 0, INIT0 1, INIT1 2, COPY 3, NOT 4, MAJ3 5): every load of the group
# still comes before its first store.
SWITCH_RUN_GROUP = r"""template <int N>
__device__ __forceinline__ void run_group(const uint2 (&rows)[GROUP], unsigned char* col0,
                                          uint32_t stride) {
  Word v[N];
  uint32_t out[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const uint2 r = rows[j];
    const Word* pa = reinterpret_cast<const Word*>(col0 + (r.x & COL_MASK) * stride);
    const Word* pb = reinterpret_cast<const Word*>(col0 + (r.x >> HALF_SHIFT) * stride);
    const Word* pc = reinterpret_cast<const Word*>(col0 + (r.y & COL_MASK) * stride);
    out[j] = r.y >> HALF_SHIFT;
    switch ((r.x >> 12) & 7u) {
      case 0: { const Word a = *pa, b = *pb; v[j] = make_uint2(~(a.x | b.x), ~(a.y | b.y)); break; }
      case 1: v[j] = splat(0u); break;
      case 2: v[j] = splat(~0u); break;
      case 3: v[j] = *pa; break;
      case 4: { const Word a = *pa; v[j] = make_uint2(~a.x, ~a.y); break; }
      default: v[j] = maj3_xor(*pa, *pb, *pc, 0u); break;
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j) *reinterpret_cast<Word*>(col0 + out[j] * stride) = v[j];
}
"""


def switch_source() -> str:
    """The shipped loop kernel with ``run_group`` replaced by
    :data:`SWITCH_RUN_GROUP`; raises if the shipped source no longer has
    exactly one ``run_group``."""
    src, n = re.subn(r"template <int N>\n__device__ __forceinline__ void run_group\(.*?\n}\n",
                     lambda _: SWITCH_RUN_GROUP, pb.LOOP_SOURCE.read_text(), flags=re.S)
    if n != 1:
        raise RuntimeError(f"expected one run_group in {pb.LOOP_SOURCE}, found {n}")
    return src


def table_of(compiled, group: int) -> pb.LoopTable:
    """The loop kernel's table with groups of at most ``group`` gates."""
    shipped = pb.GATE_GROUP
    pb.GATE_GROUP = group
    try:
        return pb.pack_rows(compiled)
    finally:
        pb.GATE_GROUP = shipped


def load(name: str, source: str) -> ctypes.CDLL:
    lib = _build.load(name, source)
    pb.bind_loop(lib)
    return lib


def launcher(lib, compiled, table, planes):
    """A function that runs ``compiled`` over ``planes`` with ``lib``'s
    kernel and ``table``, as ``pim_bitserial._launch_loop`` does."""
    table = table.to(planes.device)
    out = torch.empty((len(compiled.output_slots), planes.shape[1]), dtype=torch.int32,
                      device=planes.device)

    def run() -> torch.Tensor:
        err = pb.launch_loop(lib, table, planes, out)
        if err != 0:
            raise RuntimeError(f"loop kernel launch failed: CUDA error {err}")
        return out
    return run


def cuda_ms(fn, reps: int = REPS) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("torch_loop_probe needs a CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    print(f"device: {smi}", flush=True)
    jobs = [("bitserial_loop", pb.LOOP_SOURCE.read_text()), ("bitserial_loop_switch",
                                                             switch_source())]
    _build.build(jobs)
    shipped, switch = (load(*job) for job in jobs)
    mac = pim.compile(lambda a, b, c: a * b + c, dtype=pim.f32)
    rng = np.random.default_rng(0)
    for basis in ("memristive", "dram"):
        compiled = mac.compiled(basis)
        words = rng.integers(0, 2**32, (len(compiled.input_slots), WORDS), dtype=np.uint64)
        planes = torch.from_numpy(words.astype(np.uint32).view(np.int32)).to(dev)
        want = pb.loop_plain(compiled, planes)
        table = table_of(compiled, pb.GATE_GROUP)
        one = table_of(compiled, 1)
        versions = {"shipped": launcher(shipped, compiled, table, planes),
                    "switch": launcher(switch, compiled, table, planes),
                    "groups1": launcher(shipped, compiled, one, planes)}
        for name, run in versions.items():
            if not torch.equal(run().clone(), want):
                raise AssertionError(f"{name} differs from the plain version on {basis}")
        print(f"{basis}: {compiled.num_gates} gates; table rows: shipped {table.rows.shape[0]}, "
              f"groups1 {one.rows.shape[0]}; live state {table.state_cols} columns, "
              f"{table.words} words a block (groups1 {one.state_cols}, {one.words}); every "
              f"version equal to plain", flush=True)
        times: dict[str, list[float]] = {name: [] for name in versions}
        for name in ("shipped", "switch", "groups1", "groups1", "switch", "shipped"):
            times[name].append(cuda_ms(versions[name]))
        for name, ms in times.items():
            print(f"{basis} {name}: " + " ".join(f"{t:.4f}" for t in ms) + " ms", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
