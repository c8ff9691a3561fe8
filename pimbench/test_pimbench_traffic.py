"""The traffic generator: seeded draws repeat and hold the frozen shares."""

from __future__ import annotations

import numpy as np
import pytest

from pimbench import spec
from pimbench.traffic import Calls, smooth_order

RESNET = spec.load_json(spec.PKG / "traffic" / "resnet50_f32.json")


def test_resnet50_wave_table_totals():
    """Output elements x taps of ResNet-50's conv and FC layers at batch 8:
    54 931 waves and 30 863 785 984 MACs; the FC is 2048 taps of 8 x 1000."""
    rows = dict(RESNET["rows"])
    assert sum(rows.values()) == 54_931
    assert sum(r * w for r, w in rows.items()) == 30_863_785_984
    assert rows[8 * 1000] == 2048
    # conv1 (7 x 7 x 3 taps) and the 1 x 1 convs onto 56 x 56 x 256 share a size.
    assert rows[8 * 112 * 112 * 64] == 7 * 7 * 3 + 3 * 64 + 64


def test_one_period_holds_every_weight():
    order = smooth_order(RESNET["rows"])
    values, counts = np.unique(order, return_counts=True)
    assert dict(zip(values.tolist(), counts.tolist())) == dict(RESNET["rows"])


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**40 + 3])
def test_every_stretch_holds_the_shares(seed):
    calls = Calls(RESNET, seed)
    table = dict(RESNET["rows"])
    total = sum(table.values())
    for length in (50, 700, 2500):
        drawn = [calls.rows(i) for i in range(length)]
        for rows, weight in table.items():
            assert abs(drawn.count(rows) - weight / total * length) <= 2.0


def test_seeded_draws_repeat():
    a, b, c = Calls(RESNET, 2**31 + 99), Calls(RESNET, 2**31 + 99), Calls(RESNET, 12)
    seq = [a.rows(i) for i in range(300)]
    assert seq == [b.rows(i) for i in range(300)]
    assert a.offset != c.offset
    kept = [a.keep_slot(r) for r in seq]
    assert kept == [b.keep_slot(r) for r in seq]
    assert kept != [c.keep_slot(r) for r in seq]
    assert [a.pool_set(i) for i in range(6)] == [0, 1, 2, 3, 0, 1]


def test_bulk_traffic_sends_one_size():
    bulk = spec.load_json(spec.PKG / "traffic" / "f32_bulk.json")
    calls = Calls(bulk, 3)
    assert calls.sizes == [402_653_184]
    assert {calls.rows(i) for i in range(10)} == {402_653_184}


def test_every_size_is_kept_and_the_draw_spans_the_window():
    """Reservoir sampling keeps ``check_per_size`` calls of every size sent,
    each of a size's calls with the same chance, late ones as early ones."""
    per_size, n = RESNET["check_per_size"], 3000
    last_kept = []
    for seed in range(60):
        calls = Calls(RESNET, seed)
        kept: dict = {}
        for i in range(n):
            rows = calls.rows(i)
            slot = calls.keep_slot(rows)
            assert slot is None or 0 <= slot < per_size
            if slot is not None:
                kept[rows, slot] = i
        sent = {calls.rows(i) for i in range(n)}
        assert {r for r, _ in kept} == sent == set(calls.sizes)
        assert all(len([1 for r, _ in kept if r == size]) == min(per_size, calls.seen[size])
                   for size in sent)
        last_kept.append(max(i for (r, _), i in kept.items() if r == 401_408))
    # The kept calls of a common size lie spread over the window, not at its end.
    assert min(last_kept) < n / 2 < max(last_kept)


def test_bad_tables_are_refused():
    with pytest.raises(ValueError):
        smooth_order([[0, 1]])
    with pytest.raises(ValueError):
        smooth_order([[10, 0]])
