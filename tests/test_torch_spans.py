"""The port's span and counter registry (``repro_torch.core.spans``): nothing
recorded while off, the span tree of one ``pim.compile`` call and of one
``conv3x3`` layer, the rebuilds a rebound key records, a loop launch's
live-state attributes, the executors' launch counters and the compile
cache's counters read through their old names, and spans on the profiler's
host clock."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch.pim as pim
from repro_torch.core import ir, spans
from repro_torch.kernels import pim_bitserial

MAC = lambda a, b, c: a * b + c  # noqa: E731
N = 1000


def call_tree(n_args: int) -> list[str]:
    """The spans of one warm call of an ``n_args``-argument program on the
    CPU, in the order they open."""
    return (["pim.call"] + ["frontend.cast"] * n_args + ["pack.to_planes"] * n_args
            + ["frontend.compile_cache", "exec.run_schedule", "unpack.from_planes"])


# The spans of one warm f32 or int8 MAC call on the CPU, in the order they open.
TREE = call_tree(3)
# One warm conv3x3 layer of two input channels: each channel's gather, then
# its call of the 19-argument nine-tap program.
CONV_TREE = ["conv.layer"] + (["conv.gather"] + call_tree(19)) * 2


def _args(dtype, n=N, seed=0):
    rng = np.random.default_rng(seed)
    if dtype.kind == "fixed":
        return [torch.from_numpy(rng.integers(-128, 128, n).astype(np.int8)) for _ in range(3)]
    return [torch.from_numpy(rng.standard_normal(n).astype(np.float32)) for _ in range(3)]


@pytest.fixture(scope="module")
def macs():
    """Warm MACs by type name: compiled once, so later calls hit every cache."""
    warm = {}

    def get(dtype):
        if dtype.name not in warm:
            warm[dtype.name] = pim.compile(MAC, dtype=dtype)
            warm[dtype.name](*_args(dtype), device="cpu")
        return warm[dtype.name]
    return get


@pytest.fixture(scope="module")
def f32_mac(macs):
    return macs(pim.f32)


def _moved(before: dict, after: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


def test_off_records_nothing_and_counters_count(f32_mac):
    assert spans.span("a") is spans.span("b", rows=3)  # one shared object
    with spans.span("a") as s:
        s.set("rows", 3)
    before = spans.counters()
    f32_mac(*_args(pim.f32), device="cpu")
    assert _moved(before, spans.counters()) == {"ir.compile.hits": 1}
    with spans.recording() as rec:
        pass
    assert rec == []


@pytest.mark.parametrize("dtype", [pim.f32, pim.int8, pim.bf16], ids=lambda t: t.name)
def test_call_records_the_span_tree(macs, dtype):
    mac = macs(dtype)
    with spans.recording() as rec:
        mac(*_args(dtype), device="cpu", basis="memristive")
    assert [s.name for s in rec] == TREE
    call = rec[0]
    assert call.parent is None
    assert call.attrs == {"dtype": dtype.name, "basis": "memristive", "rows": N}
    assert {s.call_id for s in rec} == {call.call_id}
    assert all(s.parent == 0 for s in rec[1:])
    for s in rec:
        assert call.start_ns <= s.start_ns <= s.end_ns <= call.end_ns
    # Siblings follow one another.
    assert all(a.end_ns <= b.start_ns for a, b in zip(rec[1:], rec[2:]))


def test_conv_layer_records_its_span_tree():
    """A conv3x3 layer opens ``conv.layer`` around one ``conv.gather`` and
    one ``pim.call`` an input channel, all of one call id, and counts its
    calls in ``conv.waves``."""
    from repro_torch.pim.conv import conv3x3

    g = torch.Generator().manual_seed(0)
    x, w, b = (torch.randn(s, generator=g) for s in ((1, 2, 4, 4), (3, 2, 3, 3), (3,)))
    conv3x3(x, w, b)  # compiles the nine-tap program
    before = spans.counters("conv.")
    with spans.recording() as rec:
        conv3x3(x, w, b, basis="memristive")
    assert [s.name for s in rec] == CONV_TREE
    layer = rec[0]
    assert layer.attrs == {"cin": 2, "cout": 3, "hw": (4, 4), "basis": "memristive"}
    assert {s.call_id for s in rec} == {layer.call_id}
    assert [s.parent for s in rec if s.name in ("conv.gather", "pim.call")] == [0] * 4
    assert _moved(before, spans.counters("conv.")) == {"conv.waves": 2}


def test_second_call_hits_the_compile_cache():
    fn = pim.compile(lambda a, b, c: a * b - c, dtype=pim.fixed(5))  # not compiled before
    args = _args(pim.fixed(5), n=64)
    before = spans.counters("ir.compile.")
    fn(*args, device="cpu")
    first = _moved(before, spans.counters("ir.compile."))
    fn(*args, device="cpu")
    second = _moved(before, spans.counters("ir.compile."))
    assert first == {"ir.compile.misses": 1}
    assert second == {"ir.compile.misses": 1, "ir.compile.hits": 1}


def test_a_cold_call_records_its_compile_and_build():
    """A call that misses a cache records an ``ir.compile`` or ``exec.build``
    span inside the layer that missed; the next call records neither."""
    fn = pim.compile(lambda a, b, c: a * b - c, dtype=pim.fixed(6))
    args = _args(pim.fixed(6), n=64)
    with spans.recording() as rec:
        fn(*args, device="cpu", mode="unrolled")
        fn(*args, device="cpu", mode="unrolled")
    by_call = {}
    for s in rec:
        by_call.setdefault(s.call_id, []).append(s)
    assert sorted(by_call) == [0, 1]
    cold = {s.name: s for s in by_call[0]}
    assert rec[cold["ir.compile"].parent].name == "frontend.compile_cache"
    assert cold["ir.compile"].attrs == {"basis": "memristive"}
    assert rec[cold["exec.build"].parent].name == "exec.run_schedule"
    assert cold["exec.build"].attrs == {"what": "segments"}
    assert [s.name for s in by_call[1]] == TREE


def test_launches_and_cache_stats_read_as_before():
    assert set(pim_bitserial.LAUNCHES) == {"bitserial_loop", "bitserial_unrolled"}
    pim_bitserial.reset_launches()
    assert dict(pim_bitserial.LAUNCHES) == {"bitserial_loop": 0, "bitserial_unrolled": 0}
    before = dict(pim_bitserial.LAUNCHES)
    assert pim_bitserial.LAUNCHES == before
    spans.count("exec.launches.bitserial_loop", 2)
    assert pim_bitserial.LAUNCHES["bitserial_loop"] == 2
    assert {**pim_bitserial.LAUNCHES} == {"bitserial_loop": 2, "bitserial_unrolled": 0}
    assert pim_bitserial.LAUNCHES != before
    pim_bitserial.reset_launches()
    assert pim_bitserial.LAUNCHES == before
    stats = ir.cache_stats()
    assert set(stats) == {"hits", "misses"} and isinstance(stats, dict)
    assert stats == {"hits": spans.counters()["ir.compile.hits"],
                     "misses": spans.counters()["ir.compile.misses"]}


def test_a_rebound_key_records_its_rebuild():
    """Binding a key to another schedule drops its segments: the next run
    records an ``exec.build`` span again, which counts its call out of
    ``frontend.cache_hit_share``."""
    a, b = ir.compile_op("fixed_add", 4), ir.compile_op("fixed_add", 5)
    key = "spans_test/rebound"

    def builds(compiled):
        planes = torch.zeros((len(compiled.input_slots), 4), dtype=torch.int32)
        pim_bitserial.register_compiled(compiled, key)
        with spans.recording() as rec:
            pim_bitserial.run_schedule(key, planes, mode="unrolled")
        return [s.attrs["what"] for s in rec if s.name == "exec.build"]

    assert builds(a) == ["segments"]
    assert builds(a) == []  # the same schedule: kept
    assert builds(b) == ["segments"]
    assert builds(a) == ["segments"]


@pytest.mark.parametrize("basis,attrs", [
    ("memristive", {"state_cols": 127, "words": 416, "groups": 3445}),
    ("dram", {"state_cols": 122, "words": 448, "groups": 2262})])
def test_a_loop_launch_records_its_live_state(monkeypatch, basis, attrs):
    """A loop-kernel ``exec.launch`` span carries the live state's width,
    the words a block and the table's groups (the f32 MAC's 127 / 122
    columns of 160 / 155, its 12 968 / 8 697 gates in 3 445 / 2 262
    groups).  The
    CPU runs the plain version, which launches nothing, so the launch
    wrapper runs here with the library and its launch stood in for."""
    compiled = pim.compile(MAC, dtype=pim.f32).compiled(basis)
    key = pim_bitserial.register_compiled(compiled)
    monkeypatch.setattr(pim_bitserial, "_loop_lib", lambda: None)
    monkeypatch.setattr(pim_bitserial, "launch_loop", lambda lib, table, planes, out: 0)
    planes = torch.zeros((len(compiled.input_slots), 256), dtype=torch.int32)
    pim_bitserial._loop_table(key, planes.device)  # built outside the recording
    before = pim_bitserial.LAUNCHES["bitserial_loop"]
    with spans.recording() as rec:
        out = pim_bitserial._launch_loop(key, planes)
    assert out.shape == (len(compiled.output_slots), 256)
    assert [(s.name, s.attrs) for s in rec] == [("exec.launch", attrs)]
    assert attrs["groups"] == pim_bitserial._loop_table(key, planes.device).groups
    assert pim_bitserial.LAUNCHES["bitserial_loop"] == before + 1
    spans.count("exec.launches.bitserial_loop", -1)


def test_matmul_launches_read_their_counters():
    """``pim_matmul.LAUNCHES`` reads ``exec.launches.mm_<variant>``; each
    executor's ``reset_launches`` clears its own counters only."""
    from repro_torch.kernels import pim_matmul

    assert set(pim_matmul.LAUNCHES) == set(pim_matmul.VARIANTS)
    pim_matmul.reset_launches()
    pim_bitserial.reset_launches()
    spans.count("exec.launches.mm_general", 3)
    spans.count("exec.launches.bitserial_loop")
    assert pim_matmul.LAUNCHES["general"] == 3
    assert sum(pim_matmul.LAUNCHES.values()) == 3
    pim_bitserial.reset_launches()
    assert pim_matmul.LAUNCHES["general"] == 3
    spans.count("exec.launches.bitserial_loop")
    pim_matmul.reset_launches()
    assert dict(pim_matmul.LAUNCHES) == dict.fromkeys(pim_matmul.VARIANTS, 0)
    assert pim_bitserial.LAUNCHES["bitserial_loop"] == 1
    pim_bitserial.reset_launches()


def test_spans_close_on_errors_and_recordings_do_not_nest():
    with spans.recording() as rec:
        with pytest.raises(ValueError):
            with spans.span("outer"):
                with spans.span("inner", k=1):
                    raise ValueError("inside")
        with spans.span("after"):
            pass
        with pytest.raises(RuntimeError):
            with spans.recording():
                pass
    assert [(s.name, s.parent, s.call_id) for s in rec] == [
        ("outer", None, 0), ("inner", 0, 0), ("after", None, 1)]
    assert all(s.end_ns is not None and s.start_ns <= s.end_ns for s in rec)
    assert rec[1].attrs == {"k": 1}
    assert spans.span("x") is spans.span("y")  # off again


def test_counters_reset_by_prefix():
    spans.count("spans_test.a", 3)
    spans.count("spans_test.b")
    assert spans.counters("spans_test.") == {"spans_test.a": 3, "spans_test.b": 1}
    spans.reset_counters("spans_test.a")
    assert spans.counters("spans_test.") == {"spans_test.b": 1}
    spans.reset_counters("spans_test.")
    assert spans.counters("spans_test.") == {}


def test_spans_share_the_profilers_host_clock():
    """Under ``torch.profiler``, every ``aten::`` op of the call lies inside
    ``pim.call``, and each op only packing issues (``pack_bits``' sum) inside
    its ``pack.to_planes`` span, with no offset applied.  Packing writes each
    argument's planes into one buffer: no ``aten::stack`` outside the plain
    executor's own."""
    fn = pim.compile(MAC, dtype=pim.int8)
    args = _args(pim.int8, n=4096)
    fn(*args, device="cpu")
    with spans.recording() as rec, profile(activities=[ProfilerActivity.CPU]) as prof:
        fn(*args, device="cpu")
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events() if e.name().startswith("aten::")]
    call = rec[0]
    assert events and all(call.start_ns <= s and e <= call.end_ns for _, s, e in events)
    packing = [s for s in rec if s.name == "pack.to_planes"]
    sums = [(s, e) for name, s, e in events if name == "aten::sum"]
    assert len(packing) == 3 and len(sums) == 3 * 8
    for p in packing:
        inside = [1 for s, e in sums if p.start_ns <= s and e <= p.end_ns]
        assert len(inside) == 8  # one a plane
    executor = next(s for s in rec if s.name == "exec.run_schedule")
    assert not [1 for name, s, e in events if name == "aten::stack"
                and not (executor.start_ns <= s and e <= executor.end_ns)]
