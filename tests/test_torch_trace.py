"""``repro_torch.trace``: the recorder, and its spans on the join path.

Off, a span site hands back one shared object (nothing is made per
site), reads no clock and leaves nothing behind. On, spans nest (every
child's interval inside its parent's), share the op id of the
``repro_torch.join`` call they lie in, and the join path's sites appear
as often as the work they mark: one root a call, a dispatch and a
finalize a block, the probe only under ``auto``, S staged on the first
call with a fresh S only. Recording adds no key to a join's stats.
"""
import sys
import time
from collections import Counter

import numpy as np
import pytest

import repro_torch
from repro_torch import trace
from repro_torch.core.sets import SetCollection

P = trace.PREFIX
TUNING = dict(r_block=32, row_tile=8)


def collection(seed, n, universe=120):
    rng = np.random.default_rng(seed)
    sets = [np.unique(rng.integers(0, universe, rng.integers(1, 14)))
            .astype(np.int32) for _ in range(n)]
    return SetCollection(sets, universe, np.arange(n, dtype=np.int32))


def no_clock(monkeypatch):
    def boom():
        raise AssertionError("a clock was read with tracing off")
    monkeypatch.setattr(time, "time_ns", boom)


def test_off_is_one_shared_object_and_reads_no_clock(monkeypatch):
    no_clock(monkeypatch)
    assert not trace.enabled()
    assert trace.span("a") is trace.span("b")

    def sites(k):
        for _ in range(k):
            with trace.span("driver"):
                with trace.span("block.sync"):
                    trace.count("blocks")
    sites(10)  # warm: anything the interpreter caches on first use
    before = sys.getallocatedblocks()
    sites(10_000)
    assert sys.getallocatedblocks() - before < 10
    # a whole join with tracing off reads no clock either
    res = repro_torch.join(collection(1, 40), collection(2, 50), 0.5,
                           method="lfvt", device="cpu", **TUNING)
    assert res.stats["r_blocks"] == 2


def test_spans_nest_share_their_op_and_count():
    with trace.recording() as rec:
        with pytest.raises(RuntimeError):
            with trace.recording():
                pass
        with trace.span("outside"):
            pass
        for _ in range(2):
            with trace.span("join"):
                trace.count("ops")
                with trace.span("plan"):
                    with trace.span("plan.probe"):
                        trace.count("plan.probe", 3)
                with trace.span("driver"):
                    pass
    assert not trace.enabled()
    names = [s.name for s in rec.spans]
    assert names == [P + "outside"] + [P + n for n in (
        "join", "plan", "plan.probe", "driver")] * 2
    assert [s.op for s in rec.spans] == [-1, 0, 0, 0, 0, 1, 1, 1, 1]
    assert [s.parent for s in rec.spans] == [-1, -1, 1, 2, 1, -1, 5, 6, 5]
    for s in rec.spans:
        assert s.t0_ns <= s.t1_ns
        if s.parent >= 0:
            p = rec.spans[s.parent]
            assert p.t0_ns <= s.t0_ns and s.t1_ns <= p.t1_ns
    assert rec.counters == {P + "ops": 2, P + "plan.probe": 6}


@pytest.mark.parametrize("method", ["lfvt", "auto"])
def test_join_sites_under_recording(method):
    S = collection(3, 90)
    R1, R2 = collection(4, 70), collection(5, 40)
    plain = repro_torch.join(collection(4, 70), collection(3, 90), 0.5,
                             method=method, device="cpu", **TUNING)
    with trace.recording() as rec:
        res = [repro_torch.join(R, S, 0.5, method=method, device="cpu",
                                **TUNING) for R in (R1, R2)]
    assert res[0].pairs == plain.pairs
    assert set(res[0].stats) == set(plain.stats)
    per_op = [Counter(s.name for s in rec.spans if s.op == k)
              for k in (0, 1)]
    assert {s.op for s in rec.spans} == {0, 1}
    for k, got in enumerate(per_op):
        blocks = res[k].stats["r_blocks"]
        assert got[P + "join"] == 1 and got[P + "driver"] == 1
        assert got[P + "block.dispatch"] == blocks
        assert got[P + "block.finalize"] == blocks
        assert got[P + "plan.probe"] == (1 if method == "auto" else 0)
        assert got[P + "stage_s"] == (1 if k == 0 else 0)
    # every child inside its parent, the same op as its parent
    for s in rec.spans:
        if s.parent >= 0:
            p = rec.spans[s.parent]
            assert p.t0_ns <= s.t0_ns <= s.t1_ns <= p.t1_ns
            assert p.op == s.op
    c = rec.counters
    # what spans do not show: upload bytes and memoized reps found again
    assert c[P + "block.upload_bytes"] > 0
    assert c[P + "stage_s.upload_bytes"] > 0
    assert c[P + "sets.hit.sizes"] > 0
