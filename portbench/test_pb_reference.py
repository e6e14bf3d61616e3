"""The plain reference and the roofline counts against brute force at a
tiny size."""
from fractions import Fraction

import numpy as np
import pytest
import torch

from portbench import data, reference, roofline


def flat(sets):
    off = np.zeros(len(sets) + 1, np.int64)
    np.cumsum([len(s) for s in sets], out=off[1:])
    val = (np.concatenate(sets) if sets else np.zeros(0)).astype(np.int32)
    return off, val


def brute(r_sets, s_sets, t, keep=None):
    t = Fraction(str(t))
    out = set()
    for i, r in enumerate(r_sets):
        for j, s in enumerate(s_sets):
            a, b = set(r.tolist()), set(s.tolist())
            if keep is not None:
                a = {x for x in a if keep[x]}
                b = {x for x in b if keep[x]}
            inter, union = len(a & b), len(a | b)
            if inter and Fraction(inter, union) >= t:
                out.add((i, j))
    return out


@pytest.fixture(scope="module")
def tiny():
    cfg = {"universe": 300, "mean_len": 12.0, "max_len": 40, "zipf_a": 1.3,
           "len_sigma": 0.5, "threshold": 0.8, "s_sets": 400, "r_pool": 300,
           "planted_share": 0.3}
    d = data.make(cfg, 7)
    return cfg, d


def test_threshold_is_the_written_decimal():
    assert reference.threshold_ratio(0.8) == (4, 5)
    assert reference.threshold_ratio(0.5) == (1, 2)
    assert reference.threshold_ratio(0.7) == (7, 10)


@pytest.mark.parametrize("t", [0.8, 0.5, 0.9])
def test_reference_equals_brute_force(tiny, t):
    cfg, d = tiny
    rows = np.arange(300)
    pool = [d["pool"][1][d["pool"][0][i]:d["pool"][0][i + 1]] for i in rows]
    s = [d["s"][1][d["s"][0][j]:d["s"][0][j + 1]] for j in range(400)]
    want = brute(pool, s, t)
    got = reference.pairs(d["pool"], rows, d["s"], cfg["universe"], t,
                          "cpu", s_chunk=97)
    assert got == want
    if t == 0.8:
        # the planted copies at exactly t are in it
        exact = [(a, b) for a, b in want if Fraction(
            len(np.intersect1d(pool[a], s[b])),
            len(np.union1d(pool[a], s[b]))) == Fraction(4, 5)]
        assert exact


def test_boundary_pair_is_included():
    r = [np.arange(36, dtype=np.int32)]
    s = [np.r_[np.arange(4, 36), np.arange(100, 104)].astype(np.int32)]
    assert len(np.intersect1d(r[0], s[0])) / len(np.union1d(r[0], s[0])) \
        == pytest.approx(0.8)
    got = reference.pairs(flat(r), [0], flat(s), 200, 0.8, "cpu")
    assert got == {(0, 0)}


@pytest.mark.parametrize("longest,device,dtype", [
    (775, "cuda", torch.float16), (2048, "cuda", torch.float16),
    (2049, "cuda", torch.float32), (40, "cpu", torch.float32)])
def test_product_type_holds_every_intersection_exactly(longest, device,
                                                        dtype):
    assert reference.product_dtype(longest, device) == dtype


def test_long_sets_join_exactly():
    """Intersections past float16's 2048 decide pairs exactly."""
    r = [np.arange(3000, dtype=np.int32)]
    s = [np.r_[np.arange(k, 3000), np.arange(5000, 5000 + k)].astype(
        np.int32) for k in (300, 333, 334, 400)]
    # Jaccard 2700/3300, 2667/3333 (just above 0.8), 2666/3334, 2600/3400
    got = reference.pairs(flat(r), [0], flat(s), 6000, 0.8, "cpu")
    assert got == brute(r, s, 0.8) == {(0, 0), (0, 1)}


def test_control_sketch_is_the_reference_on_half_the_universe(tiny):
    cfg, d = tiny
    keep = reference.sketch_keep(cfg["universe"], 5, "cpu")
    assert 0.35 < float(keep.float().mean()) < 0.65
    rows = np.arange(300)
    pool = [d["pool"][1][d["pool"][0][i]:d["pool"][0][i + 1]] for i in rows]
    s = [d["s"][1][d["s"][0][j]:d["s"][0][j + 1]] for j in range(400)]
    got = reference.pairs(d["pool"], rows, d["s"], cfg["universe"], 0.8,
                          "cpu", keep=keep)
    assert got == brute(pool, s, 0.8, keep.numpy())
    exact = reference.pairs(d["pool"], rows, d["s"], cfg["universe"], 0.8,
                            "cpu")
    missing, extra = reference.compare(got, exact)
    assert missing + extra > 0


def test_compare():
    assert reference.compare({(1, 2), (3, 4)}, {(1, 2), (5, 6)}) == (1, 1)


def test_windows_are_lemma_3_1(tiny):
    cfg, d = tiny
    s = roofline.SortedS(*d["s"], cfg["universe"])
    assert (np.diff(s.sizes) <= 0).all()
    r_sizes = np.arange(1, 60)
    lo, hi = roofline.windows(r_sizes, s, 0.8)
    for r, a, b in zip(r_sizes, lo, hi):
        inside = [j for j in range(s.n)
                  if Fraction(4, 5) * r <= s.sizes[j] <= Fraction(5, 4) * r]
        assert list(range(a, b)) == inside


def lanes_brute(r_sets, s: roofline.SortedS, lo, hi):
    """Lane steps and in-window steps, one lane at a time."""
    rows_of = {}
    sets = [s.s_val[s.s_off[j]:s.s_off[j + 1]] for j in range(s.n)]
    for rank, j in enumerate(s.order):
        for a in sets[j].tolist():
            rows_of.setdefault(a, []).append(rank)
    lane = win = 0
    for r, a_lo, a_hi in zip(r_sets, lo, hi):
        if a_hi <= a_lo:
            continue
        for a in r.tolist():
            rows = sorted(rows_of.get(a, []))
            if not rows:
                continue
            ge = sum(x >= a_lo for x in rows)
            lane += min(len(rows), ge + 1)
            win += sum(a_lo <= x < a_hi for x in rows)
    return lane, win


def test_walk_count_equals_one_lane_at_a_time(tiny):
    cfg, d = tiny
    s = roofline.SortedS(*d["s"], cfg["universe"])
    rows = np.arange(0, 300, 3)
    off, val = d["pool"]
    r_sets = [val[off[i]:off[i + 1]] for i in rows]
    lo, hi = roofline.windows(np.diff(off)[rows], s, 0.8)
    lane, win = lanes_brute(r_sets, s, lo, hi)
    want = 2 * lane + win + 4 * int((hi - lo).sum())
    got = roofline.block_bounds("walk", off, val, rows, 7, s, 0.8, "cpu")
    assert got[2] == want
    moved = 4 * (sum(map(len, r_sets)) + len(rows)) + 4 * (
        s.elements + s.n) + 8 * 7
    assert got[1] == moved
    assert got[0] == pytest.approx(max(
        moved / roofline.HBM_BYTES_PER_S, want / roofline.INT32_OPS_PER_S))


def test_popcount_count_equals_words_nonzero_on_both_sides(tiny):
    cfg, d = tiny
    s = roofline.SortedS(*d["s"], cfg["universe"])
    rows = np.arange(0, 300, 2)
    off, val = d["pool"]
    lo, hi = roofline.windows(np.diff(off)[rows], s, 0.8)
    s_sets = [s.s_val[s.s_off[j]:s.s_off[j + 1]] for j in s.order]
    want = 0
    for i, a, b in zip(rows, lo, hi):
        rw = set((val[off[i]:off[i + 1]] // 32).tolist())
        for j in range(a, b):
            want += len(rw & set((s_sets[j] // 32).tolist()))
    got = roofline.block_bounds("popcount", off, val, rows, 0, s, 0.8,
                                "cpu", s.words("cpu"))
    assert got[2] == 3 * want
    onehot = roofline.block_bounds("onehot", off, val, rows, 0, s, 0.8,
                                   "cpu")
    assert onehot[2] == 2 * int((hi - lo).sum()) * 320
    assert roofline.block_bounds("other", off, val, rows, 0, s, 0.8,
                                 "cpu") is None
    assert s.words("cpu").dtype == torch.float16
