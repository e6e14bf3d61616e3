"""``spans.py`` on a hand-made recording, every value worked by hand.

Times are written in ms and recorded in ns. Op 0 is set-up's first op
(it stages S twice: the bitmap sheet and its compressed words); ops 1
and 2 are the window's, alike but 2 000 ms apart, and one span lies
outside every op.
"""
from types import SimpleNamespace

import pytest

from portbench import spans

MS = 1_000_000
P = "repro_torch."
#: (name, parent offset within the op or -1, t0 ms, t1 ms) of a window op
WINDOW_OP = [
    ("join", -1, 2000, 3000),            # self 1000 - 920 = 80
    ("plan", 0, 2010, 2110),             # self 60
    ("plan.probe", 1, 2020, 2060),       # 40
    ("sets.validated", 0, 2120, 2170),   # 50
    ("driver", 0, 2200, 2900),           # self 700 - 660 = 40
    ("bounds", 4, 2210, 2230),           # 20
    ("block.dispatch", 4, 2240, 2500),   # self 260 - 140 = 120
    ("block.upload", 6, 2250, 2350),     # self 100 - 40 = 60
    ("sets.bitmaps", 7, 2260, 2300),     # 40
    ("block.operands", 6, 2360, 2400),   # 40
    ("block.finalize", 4, 2500, 2880),   # self 380 - 340 = 40
    ("block.sync", 10, 2510, 2810),      # 300
    ("block.fetch", 10, 2810, 2830),     # 20
    ("block.compact", 10, 2840, 2860),   # 20
    ("result", 0, 2920, 2990),           # 70
]


def recording():
    out = [(P + "join", 0, -1, 0, 1000 * MS),
           (P + "plan", 0, 0, 10 * MS, 30 * MS),
           (P + "driver", 0, 0, 40 * MS, 900 * MS),
           (P + "stage_s", 0, 2, 50 * MS, 650 * MS),
           (P + "sets.lfvt_flat", 0, 3, 60 * MS, 560 * MS),
           (P + "stage_s", 0, 2, 660 * MS, 700 * MS),
           (P + "sets.sizes", -1, -1, 1500 * MS, 1510 * MS)]
    for op in (1, 2):
        base, shift = len(out), (op - 1) * 2000
        for name, parent, a, b in WINDOW_OP:
            out.append((P + name, op, base + parent if parent >= 0 else -1,
                        (a + shift) * MS, (b + shift) * MS))
    return SimpleNamespace(spans=out, counters={})


def test_self_times_and_the_four_numbers():
    rec = recording()
    own = spans.self_ns(rec.spans)
    assert own[7:10] == [80 * MS, 60 * MS, 40 * MS]
    assert own[7 + 4] == 40 * MS and own[7 + 6] == 120 * MS
    assert spans.window_ops(rec, 1) == [1, 2]
    assert spans.plan_ms_per_op(rec, 1) == pytest.approx(100)
    assert spans.collection_ms_per_op(rec, 1) == pytest.approx(90)
    assert spans.driver_self_ms_per_op(rec, 1) == pytest.approx(280)
    assert spans.s_stage_s(rec, 0) == pytest.approx(0.64)
    assert spans.s_stage_s(rec, 1) is None
    assert spans.plan_ms_per_op(rec, 3) is None


def test_decomposition_sums_to_the_root():
    rec = recording()
    got = spans.decomposition(rec, 1)
    assert got == pytest.approx({
        "join self": 80, "planner": 100, "collections": 90, "driver": 280,
        "upload": 60, "device wait": 320, "result": 70})
    assert sum(got.values()) == pytest.approx(1000)
    by_name = spans.self_ms_by_name(rec, 1)
    assert by_name[P + "block.dispatch"] == pytest.approx(120)
    assert by_name[P + "join"] == pytest.approx(80)
    assert spans.root_seconds(rec, 1) == [1.0, 1.0]
    assert spans.root_self_share(rec, 1) == pytest.approx(8.0)
    counts = spans.span_counts(rec, 1)
    assert counts[P + "join"] == 2 and counts[P + "block.dispatch"] == 2
    assert sum(counts.values()) == 2 * len(WINDOW_OP)
    assert P + "stage_s" not in counts
    assert spans.span_counts(rec, 0)[P + "stage_s"] == 2


def test_counters_between():
    assert spans.counters_between({"a": 1, "b": 2}, {"a": 1, "b": 5,
                                                     "c": 4}) == {"b": 3,
                                                                  "c": 4}


def test_idle_by_span_and_clock_slack():
    rec = recording()
    trace = SimpleNamespace(
        device=[("k", 2300 * MS, 2420 * MS), ("k", 2850 * MS, 2950 * MS)],
        host=[("portbench.join", 2000 * MS - 10_000, 3000 * MS + 20_000),
              ("portbench.join", 4000 * MS - 50_000, 5000 * MS + 10_000),
              ("aten::add", 2300 * MS, 2301 * MS)],
        start=2000 * MS, end=3100 * MS)
    # idle: [2000, 2300], [2420, 2850], [2950, 3100] ms, each split over
    # the innermost spans open across it
    top, inner = spans.idle_by_span(rec, trace, k=20)
    assert dict(top) == pytest.approx({
        P + n: ms / 1e3 for n, ms in (
            ("block.sync", 300), ("block.dispatch", 90), ("plan", 60),
            ("join", 60), ("sets.validated", 50), ("plan.probe", 40),
            ("sets.bitmaps", 40), ("result", 40), ("driver", 20),
            ("bounds", 20), ("block.finalize", 20), ("block.fetch", 20),
            ("block.upload", 10), ("block.compact", 10))} | {
        spans.OUTSIDE: 0.1})
    assert top[:2] == [[P + "block.sync", 0.3], [spans.OUTSIDE, 0.1]]
    assert inner == pytest.approx(100 * 720 / 880)
    assert spans.idle_by_span(rec, trace, k=3)[0][2] == pytest.approx(
        [P + "block.dispatch", 0.09])
    assert spans.clock_gaps_us(rec, trace, 1) == pytest.approx(
        [(10, 20), (50, 10)])
    assert spans.clock_slack_us(rec, trace, 1) == pytest.approx(50)
    assert spans.clock_slack_us(rec, SimpleNamespace(host=[]), 1) is None
