"""BENCHMARK.json keeps to the benchmark's contract, and every file the
harness finds by name is there and parses."""

from __future__ import annotations

import json
import re

import pytest

from pimbench import spec

BENCH = spec.load_json(spec.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "projection", "head", "expansion",
               "experts_per", "cols")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert BENCH["paths"] == ["pimbench"]
    assert BENCH["command"][1].startswith("pimbench/") and len(BENCH["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") and ".." not in w for w in BENCH["command"])


def test_names_units_and_sources():
    entries = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    assert all(NAME.match(e["name"]) for e in entries)
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    assert len(METRICS) == len(set(METRICS))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m) <= {"name", "unit", "better", "bound", "source", "layer", "moves",
                          "workloads"}


def test_end_to_end_bounds():
    names = {m["name"]: m for m in BENCH["end_to_end"]}
    assert names["setup_s"]["bound"] == 0.25
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for cell in CELLS:  # set-up, another end-to-end metric and a per-layer one
        reported = [m["name"] for m in BENCH["end_to_end"] if cell in _cells(m)]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(cell in _cells(m) for m in BENCH["per_layer"])


def _cells(metric: dict) -> set[str]:
    """The cells that report ``metric``: its own list, else (per-layer) the
    cells that report what it moves, else every cell."""
    if "workloads" in metric:
        return set(metric["workloads"])
    if "moves" in metric:
        return _cells(next(m for m in BENCH["end_to_end"] if m["name"] == metric["moves"]))
    return set(CELLS)


def test_per_layer_entries():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and _line(m["layer"])
        # A per-layer metric is read only in cells that report what it moves.
        assert _cells(m) <= _cells(e2e[m["moves"]]) <= set(CELLS)
    layers = {m["name"].removeprefix("waves."): m["layer"] for m in BENCH["per_layer"]}
    assert all(m["layer"] == layers[m["name"].removeprefix("waves.")]
               for m in BENCH["per_layer"])
    # Rooflines and shares of a peak are named as the contract asks.
    assert {m["name"] for m in BENCH["per_layer"] if m["unit"] == "%"} >= {
        "bitserial_loop_roofline", "bitserial_unrolled_roofline", "sim_mfu"}


def test_cells_and_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert all(w["chips"] in (1, 4) and _line(w["why"]) for w in BENCH["workloads"])
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(CELLS) // 4)
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["file"].startswith("pimbench/") and _line(c["source"]) and _line(c["why"])
        body = spec.load_json(spec.ROOT / c["file"])
        assert body["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and key in body
            assert not key.endswith(("_dim", "_rank")) and not any(w in key for w in WIDTH_WORDS)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load(cell):
    assert {m["name"] for m in spec.load_cell(cell).per_layer} == {
        m["name"] for m in BENCH["per_layer"] if cell in _cells(m)}
    c = spec.load_cell(cell)
    assert c.traffic["program"] == c.program["name"]
    assert c.basis in c.program["work"]
    assert max(r for r, _ in c.traffic["rows"]) <= c.machine_rows
    for key in ("pool_sets", "check_per_size", "trace_calls"):
        assert int(c.traffic[key]) >= 1
    assert {"gates", "planes_in", "planes_out"} <= set(c.work)
    assert c.end_to_end and c.per_layer


@pytest.mark.parametrize("traffic", sorted(p.stem for p in (spec.PKG / "traffic").glob("*.json")))
def test_every_traffic_file_has_its_cpu_sizes(traffic):
    """``cpu_rows``: the table in the traffic's own shape, the same weights
    in the same order, distinct sizes of at most 1024 rows."""
    body = spec.load_json(spec.PKG / "traffic" / f"{traffic}.json")
    rows, cpu = body["rows"], body["cpu_rows"]
    assert [w for _, w in cpu] == [w for _, w in rows]
    sizes = [r for r, _ in cpu]
    assert all(isinstance(r, int) and 1 <= r <= 1024 for r in sizes)
    assert len(set(sizes)) == len(sizes)


@pytest.mark.parametrize("metric", METRICS)
def test_every_metric_has_a_reader(metric):
    assert callable(spec.reader(metric).read)


def test_every_file_under_the_package_parses():
    for path in spec.PKG.rglob("*.json"):
        spec.load_json(path)
    for path in spec.PKG.rglob("*"):
        rel = path.relative_to(spec.ROOT).as_posix()
        assert "__pycache__" in rel or re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
