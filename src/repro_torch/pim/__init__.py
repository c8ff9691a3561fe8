"""``repro_torch.pim`` — the public trace-and-compile PIM frontend.

    import repro_torch.pim as pim

    mac = pim.compile(lambda a, b, c: a * b + c, dtype=pim.f32)
    z = mac(x, y, c)                       # fused execution on the GPU
    rep = mac.cost(basis="dram")           # program-level CostReport

Types: ``pim.f32``, ``pim.bf16``, ``pim.fixed(n)`` (with ``int8``/``int16``/
``int32`` aliases).
"""

from repro_torch.core.bitplanes import BF16 as bf16
from repro_torch.core.bitplanes import F32 as f32
from repro_torch.core.bitplanes import PimType, fixed

from .frontend import CompiledPimFunction, TraceError, Tracer, compile, trace

int8 = fixed(8)
int16 = fixed(16)
int32 = fixed(32)

__all__ = [
    "compile", "trace", "CompiledPimFunction", "Tracer", "TraceError",
    "PimType", "f32", "bf16", "fixed", "int8", "int16", "int32",
]
