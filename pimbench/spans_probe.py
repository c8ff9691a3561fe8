"""Run one cell's windows with the port's own spans and print what they read.

    python3 pimbench/spans_probe.py --workload memristive.f32_bulk --seed 7 --seconds 10
    python3 pimbench/spans_probe.py --workload memristive.resnet50_f32 --seed 7 --seconds 0 \\
        --loop-calls 4000 --loop-only

After set-up as ``run.py`` makes it, the probe runs the untraced window for
``--seconds``, then ``trace_calls`` calls with the port's spans on and the
profiler off, then as many with both on (``attribution.py``).  It prints
the five layer readings that those spans give (``pack.in.device_ms``,
``pack.out.device_ms``, ``host.pack_ms``, ``host.unpack_ms``,
``frontend.cache_hit_share``), the checks of the attribution against the
trace's own readings, the launch calls a call by span, the breakdown's idle
gaps named by the port's spans, and the synchronise's idle time by the span
that launched the work it follows.  It also times a span and a counter with
recording off and counts the sites a call passes.

``--loop-calls N`` times N calls of the cell's smallest size, in blocks with
recording off and on by turns: host ns a call, the spans' cost when on.
``--loop-only`` runs that loop alone (without the spans module, off only),
so that two checkouts of the port can be compared by the same loop.  The
result is one JSON object, on the last line of standard output and in
``--out``.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import timeit  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def call_stats(calls) -> dict:
    """Mean host ms a call to its return and to its synchronised end."""
    if not calls:
        return {"calls": 0}
    return {"calls": len(calls),
            "enqueue_ms": statistics.fmean(r - s for _, s, r, _ in calls) / 1e6,
            "call_ms": statistics.fmean(e - s for _, s, _, e in calls) / 1e6}


def loop(session, n: int, blocks: int = 10) -> dict:
    """``n`` calls of the traffic's smallest size, in ``blocks`` blocks with
    recording off and on by turns (off only without the spans module)."""
    try:
        from repro_torch.core import spans
    except ImportError:
        spans = None
    rows = session.calls.sizes[-1]
    xs = [x[:rows] for x in session.pool[0]]
    per_block = max(n // blocks, 1)
    got: dict[str, list[float]] = {"off": [], "on": []}
    for b in range(blocks):
        state = "on" if spans is not None and b % 2 else "off"
        ns = []
        for _ in range(per_block):
            start = time.perf_counter_ns()
            if state == "on":
                with spans.recording():
                    session.fn(*xs)
            else:
                session.fn(*xs)
            session.sync()
            ns.append(time.perf_counter_ns() - start)
        got[state].append(statistics.fmean(ns))
    return {"rows": rows, "calls_a_block": per_block,
            **{f"{k}_ns": v for k, v in got.items() if v},
            **{f"{k}_ns_median": statistics.median(v) for k, v in got.items() if v}}


def _ns_each(stmt: str, names: dict, number: int = 200_000) -> float:
    return min(timeit.repeat(stmt, globals=names, number=number, repeat=5)) / number * 1e9


def site_costs(session) -> dict:
    """ns a span site with recording off and on and a counter, and how many
    of each one call of the traffic's smallest size passes."""
    from repro_torch.core import spans

    span_ns = _ns_each('with span("x"): pass', {"span": spans.span})
    with spans.recording():
        span_on_ns = _ns_each('with span("x"): pass', {"span": spans.span}, number=20_000)
    count_ns = _ns_each('count("x")', {"count": spans.count})
    sites = {"span": 0, "count": 0}
    real_span, real_count = spans.span, spans.count

    def counted_span(*a, **k):
        sites["span"] += 1
        return real_span(*a, **k)

    def counted_count(*a, **k):
        sites["count"] += 1
        return real_count(*a, **k)

    rows = session.calls.sizes[-1]
    spans.span, spans.count = counted_span, counted_count
    try:
        session.fn(*[x[:rows] for x in session.pool[0]])
        session.sync()
    finally:
        spans.span, spans.count = real_span, real_count
    return {"span_site_ns": span_ns, "span_site_on_ns": span_on_ns, "count_ns": count_ns,
            "sites_a_call": sites,
            "off_ns_a_call": sites["span"] * span_ns + sites["count"] * count_ns,
            "on_ns_a_call": sites["span"] * span_on_ns + sites["count"] * count_ns}


def traced(session, made: int, untraced: dict) -> dict:
    """The spans-only and profiled windows, and what they read."""
    from pimbench import attribution, harness, tracing

    n = int(session.cell.traffic["trace_calls"])
    s_calls, s_fail, s_spans = attribution.spans_window(session, made, n, 1e9)
    made += len(s_calls) + len(s_fail)
    p_calls, p_fail, p_spans, prof = attribution.profiled_window(session, made, n, 1e9)
    if s_fail or p_fail or not p_calls:
        raise RuntimeError(f"failed calls: {(s_fail + p_fail)[:1]!r}")
    trace = tracing.read_profile(prof, [tracing.CallSpan(*c) for c in p_calls],
                                 attribution.layer_spans(p_spans))
    profile = attribution.read_events(prof)
    out = {"spans_only": call_stats(s_calls), "profiled": call_stats(p_calls),
           "offset_ns": trace.offset_ns}
    out["spans_on_cost"] = {k: out["spans_only"][k] / untraced[k] - 1
                            for k in ("enqueue_ms", "call_ms")}
    for label, host_offset in (("raw", 0), ("sync_offset", trace.offset_ns)):
        attr = attribution.attribute(profile, p_spans, trace, host_offset_ns=host_offset)
        out[label] = {"readings": attribution.layer_readings(attr, s_spans, p_spans),
                      "checks": attribution.checks(attr, trace),
                      "device_ms_by_span": {k: v / attr.calls / 1e6
                                            for k, v in sorted(attr.device_ns.items())}}
    out["breakdown"] = harness.breakdown(trace)
    for label, t in (("at_sync_offset", trace), ("at_zero_offset", attribution.at_offset(trace, 0))):
        out[f"sync_idle_ms_{label}"] = attribution.sync_idle(profile, p_spans, t)
        out[f"idle_gaps_{label}"] = {k: v / len(t.calls) * 1e3
                                     for k, v in tracing.idle_by_host(t).items()}
    return out


def report(result: dict) -> None:
    """The readings and each check beside what it should equal, on stderr."""
    from pimbench.attribution import within

    raw = result["raw"]
    _log(" ".join(f"{k} {v:.6g}" for k, v in raw["readings"].items()))
    for name, c in raw["checks"].items():
        ok = (c["value"] == c["of"] if name == "executor_in_launch"
              else within(c["value"], c["of"]))
        _log(f"check {name} {c['value']:.6g} against {c['of']:.6g}: {'ok' if ok else 'OFF'}")
    _log(f"launches a call by span: {raw['checks']['launches_by_span']['by_span']}")
    costs = result["site_costs"]
    _log(f"spans off {costs['off_ns_a_call']:.0f} ns a call, on {costs['on_ns_a_call']:.0f} "
         f"({costs['sites_a_call']}); spans-only window against the untraced: "
         f"{result['spans_on_cost']}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--loop-calls", type=int, default=0)
    p.add_argument("--loop-only", action="store_true")
    p.add_argument("--out", type=Path)
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from pimbench.run import CACHE_ENV, power_limit

    for key, path in CACHE_ENV.items():
        os.environ[key] = str(path)
    import torch

    from pimbench import harness, spec

    dev = torch.device("cuda")
    if not torch.cuda.is_available():
        _log("needs a CUDA device")
        return 2
    torch.set_num_threads(2)
    cell = spec.load_cell(args.workload)
    session = harness.Session(cell, args.seed, dev)
    session.warm_up()
    result = {"workload": args.workload, "seed": args.seed,
              "setup_s": time.perf_counter() - T_START,
              "device": torch.cuda.get_device_name(dev), "card": power_limit()}
    if not args.loop_only:
        calls, failures = session.drive(0, args.seconds, time.perf_counter_ns)
        if failures:
            raise RuntimeError(f"failed calls: {failures[:1]!r}")
        result["untraced"] = call_stats(calls)
        result["site_costs"] = site_costs(session)
        result.update(traced(session, len(calls), result["untraced"]))
    if args.loop_calls:
        result["loop"] = loop(session, args.loop_calls)
    if "raw" in result:
        report(result)
    line = json.dumps(result)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
