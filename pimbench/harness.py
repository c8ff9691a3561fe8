"""One run of one cell: set-up, the measured window, the traced windows, the
check against the plain reference, and the metrics.

Set-up makes the input pool from the seed on the device, compiles the
program through ``repro_torch.pim.compile`` and calls it once at every size
the cell's traffic sends (which builds the kernels on a checkout's first
run).  The window then issues calls in a closed loop for ``seconds``: each
call is ``fn(*inputs, basis=...)`` followed by ``torch.cuda.synchronize()``,
timed on the host clock.  ``check_per_size`` results of every size the
window sends, drawn from the seed over the whole window
(``traffic.Calls.keep_slot``), are copied into preallocated slots; once the
window has closed they are compared with the NumPy reference.  A traced run
then drives ``trace_calls`` more calls with the port's spans recorded, and
as many again with the spans under ``torch.profiler``, for the per-layer
metrics (``attribution.py``).
"""

from __future__ import annotations

import dataclasses
import gc
import json
import sys
import time

import numpy as np
import torch

from repro_torch.core import spans as port_spans

from . import attribution, inputs, reference, spec, tracing
from .roofline import peak_for
from .traffic import Calls


@dataclasses.dataclass
class CallRecord:
    rows: int
    seconds: float  # start to the synchronised end
    enqueue_s: float  # start to the call's return


@dataclasses.dataclass
class Run:
    """What a metric reader reads."""

    cell: spec.Cell
    calls: list[CallRecord]  # the measured window's completed calls
    window_s: float
    setup_s: float
    peak_bytes: int | None  # allocated on the card during the window
    peak: dict | None  # this card's entry in peaks.json
    trace: tracing.Trace | None = None  # the profiled window
    attribution: attribution.Attribution | None = None  # of the profiled window
    spans_only: list[port_spans.Span] | None = None  # the port's spans, profiler off
    profiled: list[port_spans.Span] | None = None  # the port's spans, profiler on
    counters: dict[str, int] | None = None  # the port's counters' rise, spans-only window


def _log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def _pim_dtype(pim, name: str):
    t = reference.elem_type(name)
    return pim.f32 if t.kind == "float32" else pim.fixed(t.nbits)


class Session:
    """The program, its inputs and the call that the window drives."""

    def __init__(self, cell: spec.Cell, seed: int, device: torch.device, *,
                 control: bool = False):
        import repro_torch.pim as pim

        self.cell, self.device = cell, device
        self.calls = Calls(cell.traffic, seed)
        sizes = self.calls.sizes
        if sizes[0] > cell.machine_rows:
            raise ValueError(f"{cell.name}: a call of {sizes[0]} rows exceeds the "
                             f"configured {cell.machine_rows} rows")
        program = cell.program
        self.pool = inputs.make_pool(program["dtype"], len(program["args"]),
                                     self.calls.sets, sizes[0], sizes[-1] // 16, seed, device)
        fn = pim.compile(reference.as_lambda(program), dtype=_pim_dtype(pim, program["dtype"]))
        kwargs = {"basis": cell.basis}
        if device.type != "cuda":
            kwargs["device"] = device.type
        if control:
            self.fn = lambda *xs: reference.control(program, xs)
        else:
            self.fn = lambda *xs: fn(*xs, **kwargs)
        self.ring = None

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def args(self, i: int) -> tuple[int, int, list[torch.Tensor]]:
        rows, s = self.calls.rows(i), self.calls.pool_set(i)
        return rows, s, [x[:rows] for x in self.pool[s]]

    def warm_up(self) -> None:
        """One call at every size the traffic sends, largest first; then the
        slots that keep the checked results, ``check_per_size`` of each size."""
        out = None
        for rows in self.calls.sizes:
            out = self.fn(*[x[:rows] for x in self.pool[0]])
            self.sync()
        self.ring = {rows: torch.empty((self.calls.per_size, rows), dtype=out.dtype,
                                       device=self.device) for rows in self.calls.sizes}
        self.sync()

    def drive(self, first: int, seconds: float, clock, max_calls: int | None = None,
              keep: dict | None = None):
        """Calls ``first, first + 1, ...`` until ``seconds`` have passed (or
        ``max_calls`` were made).  Returns ``(spans, failures)``: each
        completed call's ``(rows, start, returned, end)`` on ``clock`` (ns)
        and each failed call's exception.  With ``keep``, the kept results go
        to their slots and ``keep[(rows, slot)]`` says which call and pool set
        each came from (and what was wrong with a result of the wrong shape)."""
        spans, failures = [], []
        limit = clock() + int(seconds * 1e9)
        i = first
        while (max_calls is None or i - first < max_calls) and clock() < limit:
            rows, s, xs = self.args(i)
            start = clock()
            try:
                out = self.fn(*xs)
                returned = clock()
                self.sync()
            except Exception as exc:  # a failed call counts; the window goes on
                failures.append(exc)
                i += 1
                continue
            spans.append((rows, start, returned, clock()))
            slot = None if keep is None else self.calls.keep_slot(rows)
            if slot is not None:
                if out.shape == (rows,) and out.dtype == self.ring[rows].dtype:
                    self.ring[rows][slot].copy_(out)
                    keep[(rows, slot)] = (i, s, None)
                else:
                    keep[(rows, slot)] = (i, s, f"{tuple(out.shape)} {out.dtype}")
            i += 1
        return spans, failures


CHECK_BLOCK = 1 << 16  # rows of the reference computed at a time


def check(session: Session, keep: dict) -> tuple[int, int, int]:
    """``(wrong rows, checked calls, checked rows)`` of the kept results
    against the reference.  Copies what it needs to the host, frees the
    card's state, then computes the reference on the host."""
    got, sets = {}, {}
    for (rows, slot), (_, s, bad_shape) in keep.items():
        got[rows, slot] = None if bad_shape else session.ring[rows][slot].cpu().numpy()
        if s not in sets:
            sets[s] = [x.cpu().numpy() for x in session.pool[s]]
    session.pool = session.ring = None
    if session.device.type == "cuda":
        torch.cuda.empty_cache()
    program = session.cell.program
    wrong = rows_checked = 0
    for (rows, slot), (i, s, bad_shape) in sorted(keep.items()):
        g = got.pop((rows, slot))
        if g is None:
            _log(f"call {i} returned {bad_shape}, not {rows} rows of the slot's dtype")
            wrong += rows
            continue
        bad = 0
        for lo in range(0, rows, CHECK_BLOCK):  # blocks that stay in the host's caches
            hi = min(lo + CHECK_BLOCK, rows)
            want = reference.reference(program, [x[lo:hi] for x in sets[s]])
            n = reference.wrong_rows(program, g[lo:hi], want)
            if n and not bad:
                first = int(np.flatnonzero(reference.wrong_mask(program, g[lo:hi], want))[0])
                _log(f"call {i} ({rows} rows, set {s}): the first wrong row is {lo + first}: "
                     f"{g[lo + first]!r} against {want[first]!r}")
            bad += n
        if bad:
            _log(f"call {i} ({rows} rows, set {s}): {bad} wrong rows")
        wrong += bad
        rows_checked += rows
    return wrong, len(keep), rows_checked


def allocator_counts(dev: torch.device) -> dict:
    """The caching allocator's device allocations, frees and retries so far."""
    if dev.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(dev)
    return {k: stats.get(k, 0) for k in ("num_device_alloc", "num_device_free",
                                         "num_alloc_retries")}


STRETCH_S = 5.0


def stretches(spans, window_start: float) -> list[float]:
    """Millions of rows a second in each ``STRETCH_S`` of the window, by the
    calls that ended in it: how the pace moves within a run."""
    done: dict[int, int] = {}
    for rows, _, _, end in spans:
        k = int((end / 1e9 - window_start) // STRETCH_S)
        done[k] = done.get(k, 0) + rows
    return [round(done.get(k, 0) / STRETCH_S / 1e6, 3) for k in range(max(done, default=-1) + 1)]


def breakdown(trace: tracing.Trace) -> dict:
    """The ten device operations that took most time, and the idle time by
    what the host was doing; seconds over the traced window."""
    ops: dict[str, float] = {}
    for name, s, e, _ in trace.device:
        ops[name[:160]] = ops.get(name[:160], 0.0) + tracing.clip(s, e, trace.start, trace.end) / 1e9
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(tracing.idle_by_host(trace).items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, v] for n, v in top], "idle_gaps": [[n, v] for n, v in idle]}


def traced_windows(session: Session, run: Run, first: int, seconds: float):
    """``trace_calls`` calls from call ``first`` with the port's spans on,
    then as many with the spans under the profiler, each window cut at
    ``seconds``.  Sets ``run``'s trace (None if no profiled call completed),
    attribution, both recordings and the port's counters' rise over the
    spans-only window; returns the calls made and the failures.

    The cyclic garbage collector is off in both windows: the span records
    and the profiler's events outlive the young generations, and a full
    collection of the process's heap, tens to hundreds of ms, would land in
    whichever span it met and read as that layer's time."""
    n = int(session.cell.traffic["trace_calls"])
    gc.collect()
    gc.disable()
    try:
        before = port_spans.counters()
        s_calls, s_fail, run.spans_only = attribution.spans_window(session, first, n, seconds)
        run.counters = {k: v - before.get(k, 0) for k, v in port_spans.counters().items()
                        if v != before.get(k, 0)}
        first += len(s_calls) + len(s_fail)
        p_calls, p_fail, run.profiled, prof = attribution.profiled_window(session, first, n,
                                                                          seconds)
    finally:
        gc.enable()
    if p_calls:
        run.trace = tracing.read_profile(prof, [tracing.CallSpan(*c) for c in p_calls],
                                         run.profiled)
        run.attribution = attribution.attribute(run.trace, run.profiled)
    return len(s_calls) + len(s_fail) + len(p_calls) + len(p_fail), s_fail + p_fail


def read_metrics(entries, run: Run) -> dict:
    """Each metric's reader over ``run``; a reader that finds nothing to
    read returns None and the metric is left out."""
    out = {}
    for m in entries:
        value = spec.reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, t_start: float,
             device: str = "cuda", control: bool = False,
             traffic: dict | None = None) -> tuple[dict, list[str]]:
    """One run of cell ``name``; returns the result line's object and the
    check lines.  ``t_start`` is the process's start on ``time.perf_counter``.
    ``device`` and ``traffic`` (overrides of the traffic file's keys) are
    for the CPU tests at tiny sizes; the command never sets them."""
    cell = spec.load_cell(name)
    if traffic:
        cell = dataclasses.replace(cell, traffic={**cell.traffic, **traffic})
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    session = Session(cell, seed, dev, control=control)
    session.warm_up()
    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    allocs = allocator_counts(dev)
    window_start = time.perf_counter()
    setup_s = window_start - t_start

    keep: dict = {}
    spans, failures = session.drive(0, seconds, time.perf_counter_ns, keep=keep)
    peak_bytes = torch.cuda.max_memory_allocated(dev) if cuda else None
    allocs = {k: v - allocs[k] for k, v in allocator_counts(dev).items()}
    made = len(spans) + len(failures)
    window_s = (spans[-1][3] / 1e9 - window_start) if spans else time.perf_counter() - window_start
    _log(f"set-up {setup_s:.6f} s (peak {setup_peak} bytes); window {len(spans)} calls in "
         f"{window_s:.6f} s")
    _log(f"the caching allocator in the window: {allocs}")
    _log(f"Melem/s by {STRETCH_S:g}-s stretch: {stretches(spans, window_start)}")
    calls = [CallRecord(r, (e - s) / 1e9, (ret - s) / 1e9) for r, s, ret, e in spans]

    run = Run(cell=cell, calls=calls, window_s=window_s, setup_s=setup_s, peak_bytes=peak_bytes,
              peak=peak_for(kind) if cuda else None)
    if trace:
        t_made, t_fail = traced_windows(session, run, made, seconds)
        made += t_made
        failures += t_fail
        if run.trace is not None:
            t = run.trace
            _log(f"traced {len(t.calls)} calls in {t.window_s:.6f} s "
                 f"({t.window_s / len(t.calls) * 1e3:.4f} ms a call, untraced "
                 f"{window_s / max(len(spans), 1) * 1e3:.4f})")

    wrong, checked, rows_checked = check(session, keep)
    checks = {"wrong_rows": {"value": wrong, "max": 0},
              "failed_calls": {"value": len(failures), "max": 0},
              "checked_calls": {"value": checked, "min": 1},
              "unchecked_sizes": {"value": len({r for r, *_ in spans} - {r for r, _ in keep}),
                                  "max": 0}}
    correct = (wrong == 0 and not failures and checked >= 1
               and checks["unchecked_sizes"]["value"] == 0)
    if failures:
        _log(f"{len(failures)} calls failed; the first: {failures[0]!r}")
    result = {
        "correct": correct,
        "attempted": made,
        "failed": len(failures),
        "metrics": read_metrics(cell.per_layer if trace else cell.end_to_end, run),
        "device": {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": 1,
                   "memory_peak_bytes": max(setup_peak, peak_bytes) if cuda else None},
    }
    if run.trace is not None:
        result["device"].update(busy_s=run.trace.busy_s(), window_s=run.trace.window_s)
        result["breakdown"] = breakdown(run.trace)
        got = attribution.checks(run.attribution, run.trace)
        result["attribution"] = {"holds": attribution.checks_hold(got), **got}
        _log(f"the port's spans against the trace: {json.dumps(result['attribution'])}")
    result["checks"] = checks
    lines = [f"rows checked {rows_checked} in {checked} calls"]
    lines += [f"check {k} {v['value']} " + ("<= " + str(v["max"]) if "max" in v
                                            else ">= " + str(v["min"]))
              for k, v in checks.items()]
    return result, lines
