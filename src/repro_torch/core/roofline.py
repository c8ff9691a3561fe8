"""Three-term roofline: compute, memory and collective time of a step.

    compute term    = FLOPs       / (chips × peak_FLOP/s)
    memory term     = HBM_bytes   / (chips × HBM_bw)
    collective term = wire_bytes  / link_bw   (per device)

Two sources of per-device counts.  The reference's HLO text readers are
copied as they are (``parse_collectives``, ``analyze_hlo``,
``fused_bytes_estimate``), so the port reads a dump of the reference's
compiled step.  The port's own source is :func:`count_step`: it runs a
step on DTensors over ``meta`` tensors (a fake process group, no device)
and counts what each device does, by ``analyze_hlo``'s rules mapped onto
aten ops.  Wire bytes use the standard ring-algorithm factors; the raw
operand bytes are also reported.  The machine is a
:class:`~repro_torch.core.costmodel.GPUConfig` (default the H100: dense
bf16 tensor-core peak, HBM3, NVLink).
"""

from __future__ import annotations

import dataclasses
import math
import re
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .costmodel import H100, GPUConfig

COLLECTIVE_KINDS = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

# NB: tuple types may contain /*index=N*/ comments (hence [^()]*, not [^=]*)
_DEF_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?(?P<name>[\w.\-]+)\s*=\s*(?P<type>\([^()]*\)|[a-z0-9]+\[[0-9,]*\][^\s]*)\s*(?P<opcode>[\w\-]+)\(",
    re.M,
)
_TRIP_RE = re.compile(r'"known_trip_count":\{"n":"(\d+)"\}')
_SHAPE_RE = re.compile(r"(?P<dtype>[a-z][a-z0-9]+)\[(?P<dims>[0-9,]*)\]")
_OPERAND_RE = re.compile(r"%?([\w.\-]+)")
_GROUPS_BRACED_RE = re.compile(r"replica_groups=\{\{([0-9, ]+)\}")
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16, "u1": 1, "s1": 1,
}


def _dims_of(type_str: str) -> list[int]:
    m = _SHAPE_RE.search(type_str)
    if not m:
        return []
    return [int(d) for d in m.group("dims").split(",") if d]


def _shape_bytes(type_str: str) -> int:
    total = 0
    for m in _SHAPE_RE.finditer(type_str):
        dtype = m.group("dtype")
        dims = m.group("dims")
        n = 1
        if dims.strip():
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES.get(dtype, 4)
    return total


def _ring_factor(kind: str, group: int) -> float:
    """Per-device wire traffic as a multiple of the per-device payload."""
    if group <= 1:
        return 0.0
    g = float(group)
    if kind == "all-reduce":
        return 2.0 * (g - 1.0) / g
    if kind in ("all-gather", "reduce-scatter", "all-to-all"):
        return (g - 1.0) / g
    if kind == "collective-permute":
        return 1.0
    return 1.0


@dataclasses.dataclass
class CollectiveStats:
    operand_bytes: float = 0.0  # raw per-device operand bytes, summed
    wire_bytes: float = 0.0  # ring-model per-device wire bytes
    count: int = 0
    by_kind: dict = dataclasses.field(default_factory=lambda: defaultdict(float))


def parse_collectives(hlo_text: str, default_group: int) -> CollectiveStats:
    """Sum operand sizes of every collective op in an HLO dump (per-device)."""
    # name -> result type string (to resolve operand shapes)
    types: dict[str, str] = {}
    for m in _DEF_RE.finditer(hlo_text):
        types[m.group("name")] = m.group("type")

    stats = CollectiveStats()
    for line in hlo_text.splitlines():
        m = _DEF_RE.match(line)
        if not m:
            continue
        opcode = m.group("opcode")
        kind = None
        for k in COLLECTIVE_KINDS:
            if opcode == k or opcode.startswith(k + "-") or opcode == k + "-start":
                kind = k
                break
        if kind is None:
            continue
        if opcode.endswith("-done"):
            continue  # paired with -start; count once
        # operands: inside the outermost parens of the op call
        call = line.split(opcode + "(", 1)[1]
        depth, end = 1, 0
        for i, ch in enumerate(call):
            if ch == "(":
                depth += 1
            elif ch == ")":
                depth -= 1
                if depth == 0:
                    end = i
                    break
        arglist = call[:end]
        # strip attribute-looking tails (channel_id=..) — operands come first
        operand_bytes = 0
        for tok in arglist.split(","):
            tok = tok.strip()
            if not tok or "=" in tok:
                break
            om = _OPERAND_RE.match(tok)
            if not om:
                continue
            t = types.get(om.group(1))
            if t is None:
                # operand may carry an inline type: f32[8,16] %name
                inline = _SHAPE_RE.search(tok)
                operand_bytes += _shape_bytes(tok) if inline else 0
            else:
                operand_bytes += _shape_bytes(t)

        gm = _GROUPS_BRACED_RE.search(line)
        if gm:
            group = len([x for x in gm.group(1).split(",") if x.strip() != ""])
        else:
            gm = _GROUPS_IOTA_RE.search(line)
            group = int(gm.group(2)) if gm else default_group
        stats.count += 1
        stats.operand_bytes += operand_bytes
        wire = operand_bytes * _ring_factor(kind, group)
        stats.wire_bytes += wire
        stats.by_kind[kind] += wire
    return stats


# --------------------------------------------------------------------------
# Full HLO walk: per-computation costs scaled by while-loop trip counts.
# XLA's cost_analysis counts loop bodies ONCE; lax.scan-built models
# (layer stacks, flash-attention blocks, SSD chunks) therefore under-report.
# --------------------------------------------------------------------------

_COMP_HEAD_RE = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s*(?:\([^)]*\))?\s*->.*\{\s*$")
_WHILE_RE = re.compile(r"condition=%?([\w.\-]+),\s*body=%?([\w.\-]+)")
_CALLS_RE = re.compile(r"(?:calls|to_apply|branch_computations)=\{?%?([\w.\-]+(?:,\s*%?[\w.\-]+)*)\}?")
_CONST_RE = re.compile(r"constant\((\d+)\)")
_DIMS_ATTR_RE = re.compile(r"lhs_contracting_dims=\{([0-9,]*)\}")


def _split_computations(hlo_text: str) -> tuple[dict[str, list[str]], str | None]:
    comps: dict[str, list[str]] = {}
    entry = None
    cur = None
    for line in hlo_text.splitlines():
        stripped = line.strip()
        # computation header: "%name (args) -> type {" possibly with nested
        # parens in tuple-typed args; name may contain dots
        if (
            line
            and not line[0].isspace()
            and stripped.endswith("{")
            and "->" in line
            and "(" in line
        ):
            head = line.split("(", 1)[0].strip()
            if head.startswith("ENTRY"):
                head = head[len("ENTRY"):].strip()
                cur = head.lstrip("%")
                entry = cur
            else:
                cur = head.lstrip("%")
            comps[cur] = []
            continue
        if cur is not None:
            if stripped == "}":
                cur = None
                continue
            comps[cur].append(line)
    return comps, entry


def _loop_trip_count(cond_lines: list[str]) -> int:
    """lax.scan conditions compare the induction var to a constant bound.
    The compare may be fusion-wrapped, so take the max integer constant in
    the (tiny) condition computation."""
    best = 1
    for line in cond_lines:
        m = _CONST_RE.search(line)
        if m:
            best = max(best, int(m.group(1)))
    return best


@dataclasses.dataclass
class HLOAnalysis:
    dot_flops: float = 0.0
    hbm_bytes: float = 0.0
    collectives: "CollectiveStats" = None  # type: ignore[assignment]


def _dot_flops_of_line(line: str, types: dict[str, str]) -> float:
    m = _DEF_RE.match(line)
    if not m:
        return 0.0
    out_elems = 0
    for sm in _SHAPE_RE.finditer(m.group("type")):
        n = 1
        for d in sm.group("dims").split(","):
            if d:
                n *= int(d)
        out_elems += n
    ops = _operand_names(line, m.group("opcode"))
    k = 1
    dm = _DIMS_ATTR_RE.search(line)
    if dm and ops:
        lhs_t = types.get(ops[0], "")
        sm = _SHAPE_RE.search(lhs_t)
        if sm:
            dims = [int(d) for d in sm.group("dims").split(",") if d]
            for idx in (int(x) for x in dm.group(1).split(",") if x):
                if idx < len(dims):
                    k *= dims[idx]
    return 2.0 * out_elems * k


def analyze_hlo(hlo_text: str, default_group: int) -> HLOAnalysis:
    """Trip-count-aware dot FLOPs, fusion-aware HBM bytes, collective stats."""
    types: dict[str, str] = {}
    defs: dict[str, tuple[str, list[str]]] = {}
    for line in hlo_text.splitlines():
        m = _DEF_RE.match(line)
        if m:
            types[m.group("name")] = m.group("type")
            op = m.group("opcode").split(".")[0]
            if op in ("convert", "reshape", "transpose", "copy", "bitcast",
                      "broadcast", "multiply"):
                defs[m.group("name")] = (op, _operand_names(line, m.group("opcode")))
    comps, entry = _split_computations(hlo_text)
    out = HLOAnalysis(collectives=CollectiveStats())
    if entry is None:
        return out
    seen_stack: list[str] = []

    def _raw_bytes(name: str) -> float:
        t = types.get(name)
        return _shape_bytes(t) if t else 0.0

    def tbytes(name: str, depth: int = 6) -> float:
        """Fusion-aware operand traffic: dequant chains
        multiply(convert(int8), broadcast(scale)) load the narrow sources."""
        if depth <= 0 or name not in defs:
            return _raw_bytes(name)
        op, ops = defs[name]
        if not ops:
            return _raw_bytes(name)
        if op in ("convert", "reshape", "transpose", "copy", "bitcast", "broadcast"):
            return tbytes(ops[0], depth - 1)
        if op == "multiply":
            return sum(tbytes(o, depth - 1) for o in ops[:2])
        return _raw_bytes(name)

    def walk(comp: str, mult: float, is_entry: bool):
        if comp not in comps or comp in seen_stack:
            return
        seen_stack.append(comp)
        for line in comps[comp]:
            m = _DEF_RE.match(line)
            if not m:
                continue
            opcode = m.group("opcode")
            base = opcode.split(".")[0]
            out_bytes = _shape_bytes(m.group("type"))

            if base == "while":
                wm = _WHILE_RE.search(line)
                if wm:
                    tm = _TRIP_RE.search(line)  # XLA annotates trip counts
                    if tm:
                        trips = int(tm.group(1))
                    else:
                        trips = _loop_trip_count(comps.get(wm.group(1), []))
                    walk(wm.group(2), mult * trips, False)
                continue
            if base in ("fusion", "call", "conditional", "map", "reduce", "sort",
                        "reduce-window", "scatter", "select-and-scatter", "reduce-scatter",
                        "all-reduce"):
                cm = _CALLS_RE.search(line)
                if cm:
                    for sub in cm.group(1).replace("%", "").split(","):
                        walk(sub.strip(), mult, False)

            if base == "parameter":
                if is_entry:
                    out.hbm_bytes += out_bytes
                continue
            if is_entry and line.lstrip().startswith("ROOT "):
                out.hbm_bytes += out_bytes

            if base == "dot":
                out.dot_flops += mult * _dot_flops_of_line(line, types)
                out.hbm_bytes += mult * (
                    out_bytes + sum(tbytes(n) for n in _operand_names(line, opcode))
                )
            elif base == "convolution":
                ops = _operand_names(line, opcode)
                out_dims = _dims_of(types.get(m.group("name"), m.group("type")))
                k_dims = _dims_of(types.get(ops[1], "")) if len(ops) > 1 else []
                out_elems = 1
                for d in out_dims:
                    out_elems *= d
                k_elems = 1
                for d in k_dims:
                    k_elems *= d
                # per-output-feature kernel elems: divide out the feature dim
                feat = max((d for d in k_dims if d in set(out_dims)), default=1)
                out.dot_flops += mult * 2.0 * out_elems * max(k_elems // max(feat, 1), 1)
                out.hbm_bytes += mult * (out_bytes + sum(tbytes(n) for n in ops))
            elif base == "sort":
                out.hbm_bytes += mult * (out_bytes + sum(tbytes(n) for n in _operand_names(line, opcode)))
            elif base == "gather":
                out.hbm_bytes += mult * 2 * out_bytes
            elif base == "scatter":
                ops = _operand_names(line, opcode)
                upd = tbytes(ops[2]) if len(ops) > 2 else 0.0
                out.hbm_bytes += mult * (2 * out_bytes + upd)
            elif base == "dynamic-slice":
                out.hbm_bytes += mult * out_bytes
            elif base == "dynamic-update-slice":
                ops = _operand_names(line, opcode)
                upd = tbytes(ops[1]) if len(ops) > 1 else 0.0
                out.hbm_bytes += mult * 2 * upd
            elif any(base == k or base.startswith(k) for k in COLLECTIVE_KINDS):
                if opcode.endswith("-done"):
                    continue
                operand_bytes = sum(tbytes(n) for n in _operand_names(line, opcode))
                kind = next(k for k in COLLECTIVE_KINDS if base == k or base.startswith(k))
                gm = _GROUPS_BRACED_RE.search(line)
                if gm:
                    group = len([x for x in gm.group(1).split(",") if x.strip()])
                else:
                    gm = _GROUPS_IOTA_RE.search(line)
                    group = int(gm.group(2)) if gm else default_group
                wire = operand_bytes * _ring_factor(kind, group) * mult
                out.collectives.count += int(mult)
                out.collectives.operand_bytes += operand_bytes * mult
                out.collectives.wire_bytes += wire
                out.collectives.by_kind[kind] += wire
                out.hbm_bytes += mult * (out_bytes + operand_bytes)
        seen_stack.pop()

    walk(entry, 1.0, True)
    return out


def _operand_names(line: str, opcode: str) -> list[str]:
    call = line.split(opcode + "(", 1)
    if len(call) < 2:
        return []
    seg = call[1]
    depth, end = 1, 0
    for i, ch in enumerate(seg):
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
            if depth == 0:
                end = i
                break
    names = []
    for tok in seg[:end].split(","):
        tok = tok.strip()
        if not tok or "=" in tok:
            break
        # operand token forms: "%x" | "x" | "f32[128,256]{1,0} %x"
        om = re.search(r"%([\w.\-]+)\s*$", tok)
        if om is None and "[" not in tok and "(" not in tok:
            om = re.match(r"([\w.\-]+)$", tok)
        if om:
            names.append(om.group(1))
    return names


def fused_bytes_estimate(hlo_text: str) -> float:
    """Fusion-optimistic per-device HBM bytes of an XLA compilation.

    The CPU backend materializes every elementwise/convert/broadcast op, so
    raw ``bytes accessed`` overestimates an accelerator's HBM traffic ~30×.
    This estimator assumes perfect elementwise fusion and in-place updates:

      * ENTRY parameters read once; ENTRY root written once;
      * dot/convolution/sort/collectives: operands + outputs;
      * gather: 2× output (gathered rows in + out);
      * scatter: 2× output (read-modify-write) + updates;
      * dynamic-slice: output only; dynamic-update-slice: 2× update slice.
    """
    types: dict[str, str] = {}
    for m in _DEF_RE.finditer(hlo_text):
        types[m.group("name")] = m.group("type")

    def tbytes(name: str) -> float:
        t = types.get(name)
        return _shape_bytes(t) if t else 0.0

    total = 0.0
    in_entry = False
    for line in hlo_text.splitlines():
        if line.startswith("ENTRY"):
            in_entry = True
            continue
        if in_entry and line.startswith("}"):
            in_entry = False
        m = _DEF_RE.match(line)
        if not m:
            continue
        opcode = m.group("opcode")
        out_bytes = _shape_bytes(m.group("type"))
        base = opcode.split(".")[0]
        if base == "parameter":
            if in_entry:
                total += out_bytes
            continue
        if in_entry and line.lstrip().startswith("ROOT "):
            total += out_bytes  # entry outputs written once
        if base in ("dot", "convolution", "sort") or base.startswith(
            ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")
        ):
            total += out_bytes
            for name in _operand_names(line, opcode):
                total += tbytes(name)
        elif base == "gather":
            total += 2 * out_bytes
        elif base == "scatter":
            ops = _operand_names(line, opcode)
            upd = tbytes(ops[2]) if len(ops) > 2 else 0.0
            total += 2 * out_bytes + upd
        elif base == "dynamic-slice":
            total += out_bytes
        elif base == "dynamic-update-slice":
            ops = _operand_names(line, opcode)
            upd = tbytes(ops[1]) if len(ops) > 1 else 0.0
            total += 2 * upd
    return total


# --------------------------------------------------------------------------
# The port's source of counts: one step on DTensors over meta tensors.
# --------------------------------------------------------------------------

@dataclasses.dataclass
class StepCounts:
    """Per-device counts of one step."""
    dot_flops: float = 0.0  # products (mm/bmm/addmm/baddbmm/convolution) on the local shards
    hbm_bytes: float = 0.0  # analyze_hlo's rules, mapped onto aten ops
    collectives: CollectiveStats = dataclasses.field(default_factory=CollectiveStats)

    def scaled(self, other: "StepCounts", repeats: int) -> "StepCounts":
        """Counts of a model with ``repeats`` units from ``self`` (one unit)
        and ``other`` (two): the second unit's counts, ``other − self``,
        ``repeats − 1`` more times — the reference scales a loop body by its
        trip count."""
        k = repeats - 1
        col = CollectiveStats(
            operand_bytes=self.collectives.operand_bytes
            + k * (other.collectives.operand_bytes - self.collectives.operand_bytes),
            wire_bytes=self.collectives.wire_bytes
            + k * (other.collectives.wire_bytes - self.collectives.wire_bytes),
            count=self.collectives.count + k * (other.collectives.count - self.collectives.count),
        )
        for kind in set(self.collectives.by_kind) | set(other.collectives.by_kind):
            a, b = self.collectives.by_kind.get(kind, 0.0), other.collectives.by_kind.get(kind, 0.0)
            col.by_kind[kind] = a + k * (b - a)
        return StepCounts(self.dot_flops + k * (other.dot_flops - self.dot_flops),
                          self.hbm_bytes + k * (other.hbm_bytes - self.hbm_bytes), col)


_aten = torch.ops.aten
_PRODUCTS = {_aten.mm.default, _aten.bmm.default, _aten.addmm.default, _aten.baddbmm.default}
_CONVS = {_aten.convolution.default, _aten.convolution_backward.default}
_OPERANDS_AND_OUTPUT = {_aten.sort.default, _aten.sort.stable, _aten.topk.default}
_GATHERS = {_aten.embedding.default, _aten.index_select.default, _aten.gather.default,
            _aten.index.Tensor}
_SCATTERS = {  # op → index of the update among its arguments
    _aten.index_put.default: 2, _aten.index_put_.default: 2, _aten._index_put_impl_.default: 2,
    _aten.index_copy.default: 3, _aten.index_copy_.default: 3, _aten.index_add.default: 3,
    _aten.index_add_.default: 3, _aten.scatter.src: 3, _aten.scatter_.src: 3,
    _aten.scatter_add.default: 3, _aten.scatter_add_.default: 3,
    _aten.embedding_dense_backward.default: 0,
}
_SLICE_WRITES = {_aten.copy_.default: 1, _aten.fill_.Scalar: 0, _aten.fill_.Tensor: 0}
_COLLECTIVES = {  # functional collective → (kind, index of the group name)
    "all_reduce": ("all-reduce", 2), "all_reduce_": ("all-reduce", 2),
    "all_gather_into_tensor": ("all-gather", 2), "reduce_scatter_tensor": ("reduce-scatter", 3),
    "all_to_all_single": ("all-to-all", 3),
}


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _tensors(tree):
    """Every tensor of a tree of dicts, lists, tuples and modules, as the
    local shard each device holds."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, torch.nn.Module):
        tree = tree.state_dict()
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, DTensor):
        yield tree.to_local()
    elif isinstance(tree, torch.Tensor):
        yield tree


class _Counter(TorchDispatchMode):
    """Counts the local ops of a step.  Ops on DTensors are left to
    DTensor (which issues the local ops and collectives, seen here in
    turn); ops on fake tensors are DTensor's propagation of global shapes
    and are not counted."""

    def __init__(self, counts: StepCounts):
        super().__init__()
        self.c = counts
        self.scale = 1.0

    def weigh(self, trips: int):
        """One trip of a loop whose ``trips`` trips have equal shapes,
        counted ``trips`` times (``models.spmd.trips``)."""
        self.scale *= trips
        try:
            yield 0
        finally:
            self.scale /= trips

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        flat = [a for a in (*args, *kwargs.values()) if isinstance(a, torch.Tensor)]
        if not any(isinstance(a, FakeTensor) for a in flat):
            self._count(func, args, flat, out)
        return out

    def _count(self, func, args, flat, out):
        c, k = self.c, self.scale
        outs = [o for o in (out if isinstance(out, (tuple, list)) else (out,))
                if isinstance(o, torch.Tensor)]
        out_bytes = sum(_nbytes(o) for o in outs)
        if func in _PRODUCTS:
            a, b = args[-2], args[-1]
            c.dot_flops += k * 2.0 * math.prod(a.shape) * b.shape[-1]
            c.hbm_bytes += k * (out_bytes + sum(_nbytes(t) for t in flat))
        elif func in _CONVS:
            w = args[2] if func is _aten.convolution_backward.default else args[1]
            y = args[0] if func is _aten.convolution_backward.default else out
            per_out = 2.0 * y.numel() * (w.numel() / w.shape[0])
            grads = sum(1 for o in outs[:2]) if func is _aten.convolution_backward.default else 1
            c.dot_flops += k * per_out * grads
            c.hbm_bytes += k * (out_bytes + sum(_nbytes(t) for t in flat))
        elif func in _OPERANDS_AND_OUTPUT:
            c.hbm_bytes += k * (out_bytes + sum(_nbytes(t) for t in flat))
        elif func in _GATHERS:
            c.hbm_bytes += k * 2 * out_bytes
        elif func in _SCATTERS:
            c.hbm_bytes += k * (2 * out_bytes + _nbytes(args[_SCATTERS[func]]))
        elif func in _SLICE_WRITES and args[0]._is_view():
            c.hbm_bytes += k * 2 * _nbytes(args[_SLICE_WRITES[func]] if func is _aten.copy_.default
                                           else args[0])
        elif func.namespace == "_c10d_functional" and func._opname in _COLLECTIVES:
            from torch.distributed.distributed_c10d import _resolve_process_group

            kind, at = _COLLECTIVES[func._opname]
            group = _resolve_process_group(args[at]).size()
            operand = k * _nbytes(args[0])
            wire = operand * _ring_factor(kind, group)
            c.collectives.count += int(k)
            c.collectives.operand_bytes += operand
            c.collectives.wire_bytes += wire
            c.collectives.by_kind[kind] += wire
            c.hbm_bytes += k * out_bytes + operand


def count_step(step, *args) -> StepCounts:
    """Per-device counts of ``step(*args)``, run here on the arguments (a
    model, optimizer state, batch or caches: DTensors over ``meta`` shards
    on a fake mesh): products on the local shards, collectives with their
    group sizes, and HBM bytes — every argument read once and every output
    written once, plus what each product, gather, scatter, slice write and
    collective moves (elementwise ops are taken as fused: nothing)."""
    from torch.distributed.tensor.experimental import implicit_replication

    counts = StepCounts()
    counts.hbm_bytes += sum(_nbytes(t) for t in _tensors(args))
    with implicit_replication(), _Counter(counts):
        out = step(*args)
    counts.hbm_bytes += sum(_nbytes(t) for t in _tensors(out))
    return counts


@dataclasses.dataclass
class RooflineReport:
    cell: str
    chips: int
    flops_global: float
    hbm_bytes_global: float
    collective_wire_bytes_per_dev: float
    collective_operand_bytes_per_dev: float
    collective_count: int
    by_kind: dict
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    bytes_per_device: float | None = None
    gpu: GPUConfig = H100

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s, "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_time_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs: catches remat/redundancy waste."""
        return self.model_flops / self.flops_global if self.flops_global else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the chips' peak compute the step achieves at the bound
        (MFU at the modeled bottleneck)."""
        ideal = self.model_flops / (self.chips * self.gpu.peak_fp16)
        return ideal / self.bound_time_s if self.bound_time_s else 0.0

    def row(self) -> dict:
        return {
            "cell": self.cell,
            "chips": self.chips,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def build_report(
    cell: str,
    chips: int,
    flops_per_device: float,
    hbm_bytes_per_device: float,
    hlo_text: str | None,
    model_flops: float,
    gpu: GPUConfig = H100,
    bytes_per_device: float | None = None,
    use_fused_bytes: bool = True,
    collectives: CollectiveStats | None = None,
) -> RooflineReport:
    """Per-device quantities in, the three terms out (globals are ×chips).

    From an HLO dump (``hlo_text``), as the reference reads it: FLOPs and
    bytes default to the trip-count-aware walk (``analyze_hlo``).  From
    :func:`count_step` (``hlo_text=None``): its FLOPs, bytes and
    ``collectives`` as they are."""
    if hlo_text is None:
        col = collectives or CollectiveStats()
    elif use_fused_bytes:
        a = analyze_hlo(hlo_text, default_group=chips)
        col = a.collectives
        hbm_bytes_per_device = a.hbm_bytes
        # dots dominate; add the non-dot remainder from cost_analysis as-is
        flops_per_device = max(flops_per_device, a.dot_flops)
    else:
        col = parse_collectives(hlo_text, default_group=chips)
    flops_global = flops_per_device * chips
    hbm_global = hbm_bytes_per_device * chips
    return RooflineReport(
        cell=cell,
        chips=chips,
        flops_global=flops_global,
        hbm_bytes_global=hbm_global,
        collective_wire_bytes_per_dev=col.wire_bytes,
        collective_operand_bytes_per_dev=col.operand_bytes,
        collective_count=col.count,
        by_kind=dict(col.by_kind),
        compute_s=flops_global / (chips * gpu.peak_fp16),
        memory_s=hbm_global / (chips * gpu.mem_bw),
        collective_s=col.wire_bytes / gpu.link_bw,
        model_flops=model_flops,
        bytes_per_device=bytes_per_device,
        gpu=gpu,
    )
