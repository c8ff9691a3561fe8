"""Paper metrics: compute complexity (§3, ref [12]) and data reuse (§4).

The paper's two-axis criterion (Fig 8):

* **compute complexity** CC = logic gates per I/O bit — low CC favors PIM;
* **data reuse** = FLOPs per byte moved (arithmetic intensity) — high reuse
  lets the accelerator escape the memory wall, erasing PIM's advantage.
"""

from __future__ import annotations

import dataclasses

from .costmodel import GPUConfig, PIMConfig


def compute_complexity(gates: int, io_bits: int) -> float:
    """Paper §3: number of logic gates performed per input+output bit."""
    return gates / io_bits


def data_reuse_matmul(n: int) -> float:
    """O(n) reuse for n×n matmul: 2n³ FLOPs over 3n² words (paper §4)."""
    return 2 * n**3 / (3 * n**2)


def data_reuse_conv(k: int) -> float:
    """O(k²) reuse for k×k conv on W×H images (paper §4)."""
    return float(k * k)


@dataclasses.dataclass(frozen=True)
class ImprovementPoint:
    """One point of the paper's Fig 4 (CC vs improvement over memory-bound GPU)."""

    op: str
    cc: float
    pim_throughput: float
    gpu_membound: float

    @property
    def improvement(self) -> float:
        return self.pim_throughput / self.gpu_membound


def fig4_points(pim: PIMConfig, gpu: GPUConfig, gate_counts: dict[str, int],
                io_bits: dict[str, int] | None = None) -> list[ImprovementPoint]:
    """Reconstruct Fig 4: inverse relation between CC and PIM/GPU improvement.

    ``io_bits`` maps op name → input+output bits per element; pass the widths
    derived from ``aritpim._OP_TABLE`` metadata (``aritpim.op_io_bits``) as
    ``benchmarks/fig4_cc.py`` does.  Without it a name-parsing fallback
    covers the paper's Fig-3/4 op set."""
    out = []
    for op, gates in sorted(gate_counts.items()):
        if io_bits is not None and op in io_bits:
            bits = io_bits[op]
        else:
            nbits = 32 if "32" in op else 16
            bits = (4 if "mul" in op and "fixed" in op else 3) * nbits
        bytes_per_op = bits // 8
        out.append(
            ImprovementPoint(
                op=op,
                cc=compute_complexity(gates, bits),
                pim_throughput=pim.op_throughput(gates),
                gpu_membound=gpu.membound_throughput(bytes_per_op),
            )
        )
    return out


def accelerator_membound(gpu: GPUConfig, bytes_per_op: int) -> float:
    """Ops/second of a memory-bound op on ``gpu``."""
    return gpu.mem_bw / bytes_per_op


def machine_balance(gpu: GPUConfig) -> float:
    """FLOPs/byte at which the dense bf16/fp16 tensor-core rate and memory
    bandwidth cross (H100: ~295)."""
    return gpu.peak_fp16 / gpu.mem_bw
