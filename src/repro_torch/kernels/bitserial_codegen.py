"""Generate the CUDA C source of the straight-line bit-serial kernel for one
schedule.

Replaces the TPU kernel ``_unrolled_segment_kernel`` (driven by
``_run_unrolled_segment`` / ``_run_unrolled``) in
``src/repro/kernels/pim_bitserial.py``: the same column-allocated schedule
as code on fixed column variables, one thread per packed word.

Each segment of ``pim_bitserial._segments`` becomes one ``__global__``
function.  A segment holds its columns in ``uint32_t`` locals (registers
where they fit); each wave chunk computes every result into a temporary
from pre-chunk values, then assigns the columns — the read-then-write
contract of the reference's ``_emit_chunks``.  Segment 0 reads its columns
from the input planes (the rest start at zero), the last segment writes
the output planes, and a multi-segment schedule threads the
``[num_cols, W]`` state through device memory between launches: a segment
loads the columns it reads before writing them and stores the columns it
writes (segment 0 also stores the input columns).

Bound on this card: one logic op per gate-word on the INT32 lanes, like
the loop kernel, but with no shared-memory traffic or dispatch per gate.
Long segments hold up to ``num_cols`` live values, so the forced
straight-line f32 MAC may spill registers; ``-Xptxas -v`` reports it.
"""

from __future__ import annotations

from repro_torch.core.machine import (
    OP_INIT0,
    OP_INIT1,
    OP_MAJ3,
    OP_NOR,
    OP_NOT,
    operand_slots,
)

THREADS_PER_BLOCK = 256

_HEADER = """\
// Generated by repro_torch/kernels/bitserial_codegen.py for schedule {key}
// ({gates} gates, {num_cols} columns, {n_seg} segment(s)).  Do not edit.
#include <cstdint>
#include <cuda_runtime.h>
"""

_FOOTER = """\
extern "C" int bitserial_segment_launch(int seg, const void* in, void* state,
                                        void* out, long long W, void* stream) {{
  const unsigned blocks = (unsigned)((W + {tpb} - 1) / {tpb});
  switch (seg) {{
{cases}
    default: return (int)cudaErrorInvalidValue;
  }}
  return (int)cudaGetLastError();
}}

extern "C" int bitserial_segment_count() {{ return {n_seg}; }}

extern "C" const char* bitserial_error_string(int err) {{
  return cudaGetErrorString((cudaError_t)err);
}}
"""


def _expr(op: int, a: int, b: int, c: int) -> str:
    if op == OP_NOR:
        return f"~(c{a} | c{b})"
    if op == OP_MAJ3:
        return f"(c{a} & c{b}) | (c{a} & c{c}) | (c{b} & c{c})"
    if op == OP_NOT:
        return f"~c{a}"
    if op == OP_INIT0:
        return "0u"
    if op == OP_INIT1:
        return "0xFFFFFFFFu"
    return f"c{a}"  # OP_COPY


def segment_plan(chunks, first: bool, last: bool, input_slots, output_slots):
    """Which columns a segment loads at entry and stores at exit.

    ``loads`` are the columns read before this segment writes them (plus,
    in the last segment, output columns it never writes); ``stores`` are
    the columns it writes (segment 0 also stores the input columns), none
    in the last segment, which writes the output planes instead."""
    written: set[int] = set()
    needed: list[int] = []
    for chunk in chunks:
        for op, a, b, c, _o in chunk:
            for s in operand_slots(op):
                col = (a, b, c)[s]
                if col not in written and col not in needed:
                    needed.append(col)
        written.update(o for *_, o in chunk)
    if last:
        needed += [col for col in output_slots
                   if col not in written and col not in needed]
    stores: list[int] = []
    if not last:
        stores = sorted(written | (set(input_slots) if first else set()))
    return sorted(needed), stores, sorted(written)


def generate(compiled, segments) -> str:
    """CUDA C source for ``compiled`` split into ``segments`` (lists of wave
    chunks of ``(op, a, b, c, o)`` rows), with one C entry point
    ``bitserial_segment_launch(seg, in, state, out, W, stream)``."""
    input_slots = list(compiled.input_slots)
    output_slots = list(compiled.output_slots)
    n_seg = len(segments)
    parts = [_HEADER.format(key=compiled.key, gates=compiled.num_gates,
                            num_cols=compiled.num_cols, n_seg=n_seg)]
    cases = []
    for s, chunks in enumerate(segments):
        first, last = s == 0, s == n_seg - 1
        loads, stores, written = segment_plan(chunks, first, last, input_slots,
                                              output_slots)
        lines = [
            f'extern "C" __global__ void __launch_bounds__({THREADS_PER_BLOCK})',
            f"bitserial_seg{s}(const uint32_t* __restrict__ in, "
            "uint32_t* __restrict__ state, uint32_t* __restrict__ out, "
            "long long W) {",
            "  const long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x;",
            "  if (w >= W) return;",
        ]
        loaded = set(loads)
        if first:
            # Pre-schedule state: inputs in their slots, everything else zero.
            slot_of = {col: i for i, col in enumerate(input_slots)}
            for col in sorted(loaded | set(stores)):
                src = (f"in[{slot_of[col]}LL * W + w]" if col in slot_of
                       else "0u")
                lines.append(f"  uint32_t c{col} = {src};")
        else:
            for col in sorted(loaded):
                lines.append(f"  uint32_t c{col} = state[{col}LL * W + w];")
        declared = loaded | (set(stores) if first else set())
        for col in written:
            if col not in declared:
                lines.append(f"  uint32_t c{col};")
        for chunk in chunks:
            lines.append("  {")
            for k, (op, a, b, c, _o) in enumerate(chunk):
                lines.append(f"    const uint32_t t{k} = {_expr(op, a, b, c)};")
            for k, (*_, o) in enumerate(chunk):
                lines.append(f"    c{o} = t{k};")
            lines.append("  }")
        for col in stores:
            lines.append(f"  state[{col}LL * W + w] = c{col};")
        if last:
            for j, col in enumerate(output_slots):
                lines.append(f"  out[{j}LL * W + w] = c{col};")
        lines.append("}")
        parts.append("\n".join(lines) + "\n")
        cases.append(
            f"    case {s}: bitserial_seg{s}<<<blocks, {THREADS_PER_BLOCK}, 0, "
            "(cudaStream_t)stream>>>((const uint32_t*)in, (uint32_t*)state, "
            "(uint32_t*)out, W); break;")
    parts.append(_FOOTER.format(tpb=THREADS_PER_BLOCK, cases="\n".join(cases),
                                n_seg=n_seg))
    return "\n".join(parts)
