"""The run scan of the walk kernels K1/K6, modelled in numpy.

The CUDA kernels of ``src/repro_torch/kernels/csrc/lfvt_walk.cu`` walk
one R row per CTA, each lane with a team of 4 warps that covers 1 024
positions of the fused ``seq_row``/``seq_next`` chain a step, 32 a warp
scan: two ballots a scan find the first position where the run breaks
(its hop, clamped at the root, is not ``p - 1``) and the first row below
``lo``, and the team takes the first such event of the step; the lane's
steps, count adds,
``walk_steps`` and early stop follow from them, under the ``rem`` and
``max_steps`` caps, in column passes of ``cols`` shared count columns.
``scan_lane`` and ``scan_walk`` below follow the same ballots, breaks,
stop, caps and passes (the model lives here, not in the package), and
are held against the port's plain version and the JAX package's jnp
twin, on ``encode()`` tables, on tables grown by ``IncrementalLFVT``
(appends, the prepend fast path and the chain re-encode fallback) and on
crafted chains (unsorted lanes, ``rem`` past the root, ``max_steps``
below ``rem``): masks, counts, ``walk_steps`` and ``early_stops`` must
be equal. Two property tests pin what the design rests on: every hop
walked on an ``encode()`` table lowers the row (Theorem 3.3), and a grown
table may walk hops that do not, so no shortcut may search a run by row.
The kernels themselves are held against the plain version on the card in
``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import lfvt_walk as ref_walk
from repro_torch.core.lfvt_flat import IncrementalLFVT
from repro_torch.core.sets import SetCollection
from repro_torch.core.tile_join import window_bounds
from repro_torch.kernels import lfvt_walk as port_walk
from repro_torch.kernels import ops

MEASURES = ("jaccard", "cosine", "dice", "overlap")
#: positions a step of the model takes: one warp's 32-position scan, and
#: a team step of the kernels (csrc/lfvt_walk.cu: kTeamWarps = 4 warps of
#: kScans = 8 scans)
SPANS = (32, 1024)
UNIVERSE = 40
TM = 4


def zipf_sets(seed, n, max_size=12, universe=UNIVERSE):
    rng = np.random.default_rng(seed)
    return [np.unique(np.minimum(rng.zipf(1.3, size=int(rng.integers(
        1, max_size + 1))) - 1, universe - 1)) for _ in range(n)]


# ---------------------------------------------------------------------- #
# the model
# ---------------------------------------------------------------------- #
def scan_lane(seq, nxt, p, rem, max_steps, lo, cl, ch, acc, span=32):
    """One lane, as the kernel walks it from position ``p``: ``span``
    positions a step (32 for one warp's scan, a team's span for the
    team), adding 1 at ``acc[row]`` for each stepped row in ``[cl, ch)``.
    -> (steps k, 1 if it stopped below ``lo`` with rem > 1 else 0)."""
    j = np.arange(span)
    k = 0
    while True:
        avail = min(rem, max_steps - k)
        if avail <= 0:
            return k, 0
        q = p - j
        valid = q >= 0
        qc = np.where(valid, q, 0)
        row = np.where(valid, seq[qc], 0)
        hop = np.maximum(np.where(valid, nxt[qc], 0), 0)
        brk = ~valid | (hop != q - 1)
        stp = valid & (row < lo)
        b = int(np.argmax(brk)) if brk.any() else span - 1
        s = int(np.argmax(stp)) if stp.any() else span
        if b == 0 and hop[0] == p and s > 0:  # a position hopping to itself
            if cl <= row[0] < ch:
                acc[row[0]] += avail
            return k + avail, 0
        last = min(b, avail - 1, s)
        hit = row[:last + 1]
        np.add.at(acc, hit[(hit >= cl) & (hit < ch)], 1)
        k += last + 1
        if last == s:
            return k, int(rem - s > 1)
        rem -= last + 1
        if last == avail - 1:
            return k, 0
        p = int(hop[b]) if brk.any() and last == b else p - span


def scan_walk(ti, lane_pos, lane_rem, nxt2d, seq2d, ssz2d, rsz, lo, hi, *,
              t, measure, max_steps, tm, cols, span=32):
    """K1 as the kernel computes it, row by row in column passes of
    ``cols``, ``span`` positions a step -> (masks, counts, walk_steps,
    early_stops) as numpy, plus the column passes of every walked row."""
    seq, nxt = seq2d[0].astype(np.int64), nxt2d[0].astype(np.int64)
    NP = ssz2d.shape[1]
    L = len(ti)
    counts = np.zeros((L * tm, NP), np.int64)
    steps = np.zeros(L, np.int64)
    stops = np.zeros(L, np.int64)
    passes_seen = []
    for li, tile in enumerate(ti):
        for r in range(tm):
            g = int(tile) * tm + r
            lo_r, hi_r = max(int(lo[g, 0]), 0), min(int(hi[g, 0]), NP)
            w0 = lo_r & ~15 if lo_r < hi_r else 0
            passes = -(-(hi_r - w0) // cols) if lo_r < hi_r else 1
            passes_seen.append(passes)
            for ps in range(passes):
                c0 = w0 + ps * cols
                cl, ch = max(lo_r, c0), min(hi_r, c0 + cols)
                for j in range(lane_pos.shape[1]):
                    rem = int(lane_rem[g, j])
                    if rem <= 0:
                        continue
                    k, stop = scan_lane(seq, nxt, int(lane_pos[g, j]), rem,
                                        max_steps, lo_r, cl, ch,
                                        counts[li * tm + r], span)
                    if ps == 0:
                        steps[li] = max(steps[li], k)
                        stops[li] += stop
    mask = port_walk._qualify(
        torch.tensor(counts, dtype=torch.int32),
        torch.tensor(rsz).reshape(-1, tm)[torch.tensor(ti).long()]
        .reshape(-1, 1), torch.tensor(ssz2d),
        torch.tensor(lo).reshape(-1, tm)[torch.tensor(ti).long()]
        .reshape(-1, 1),
        torch.tensor(hi).reshape(-1, tm)[torch.tensor(ti).long()]
        .reshape(-1, 1), t, measure).numpy().reshape(L, tm, NP)
    return ([mask, mask.sum(axis=(1, 2)).reshape(L, 1), steps.reshape(L, 1),
             stops.reshape(L, 1)], passes_seen)


# ---------------------------------------------------------------------- #
# operands
# ---------------------------------------------------------------------- #
def table_operands(table, seed, measure, t, tm=TM):
    """The walk's operands for a seeded R block against an ``encode()``
    table or a grown ``IncrementalLFVT`` table, as the dispatch makes
    them -> (numpy operands with ``ti`` first, static arguments, flat)."""
    S = SetCollection.from_ragged(zipf_sets(seed, 30), universe=UNIVERSE)
    R_sets = zipf_sets(seed + 100, 14)
    if table == "encode":
        flat = S.sort_by_size().flat_lfvt()
        r_sz = np.asarray([len(a) for a in R_sets], np.int64)
        lo, hi = window_bounds(r_sz, flat.s_sizes, t, measure)
    else:
        enc = IncrementalLFVT(S, capacity_grain=4)
        enc.append([np.asarray([0])])            # prepend fast path
        enc.append([np.arange(0, 14)])           # chain re-encode
        enc.append(zipf_sets(seed + 200, 10))
        assert enc.stats["merged_chains"] and enc.stats["prepend_fast_path"]
        flat = enc.flat
        r_sz = np.asarray([len(a) for a in R_sets], np.int64)
        lo, hi = enc.window_bounds(r_sz, t, measure)
    R = SetCollection.from_ragged(R_sets, universe=UNIVERSE)
    r_pad = torch.tensor(R.padded()[0])
    ti, operands, _ = ops.walk_operands(flat, r_pad, r_sz, lo, hi, tm)
    args = {"ti": ti.numpy()}
    args.update(zip(("lane_pos", "lane_rem", "nxt2d", "seq2d", "ssz2d",
                     "rsz", "lo", "hi"), (x.numpy() for x in operands)))
    kw = dict(t=t, measure=measure, max_steps=int(flat.max_seq_len), tm=tm)
    return args, kw, flat


def plain(args, kw):
    out = port_walk.lfvt_walk_live_tiled_ref(
        *[torch.tensor(v) for v in args.values()], **kw)
    return [x.numpy() for x in out]


def reference(args, kw):
    out = ref_walk.lfvt_walk_live_tiled_ref(
        *[jnp.asarray(v) for v in args.values()], **kw)
    return [np.asarray(x) for x in out]


def assert_same(got, want):
    for g, w, name in zip(got, want, ("masks", "counts", "walk_steps",
                                      "early_stops"), strict=True):
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


# ---------------------------------------------------------------------- #
# the model against the plain version and the reference twin
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("table", ["encode", "grown"])
@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("t", [0.5, 0.8])
def test_run_scan_matches_plain_and_reference(table, measure, t):
    """One pass (the launch's ``cols``) and 16-column passes give the
    plain version's and the reference twin's outputs."""
    args, kw, _ = table_operands(table, 3, measure, t)
    want = plain(args, kw)
    assert_same(reference(args, kw), want)
    NP = args["ssz2d"].shape[1]
    for span in SPANS:
        for cols in (port_walk.walk_pass_cols(NP), 16):
            got, passes = scan_walk(*args.values(), cols=cols, span=span,
                                    **kw)
            assert_same(got, want)
            if cols == 16:
                assert max(passes) > 1  # the windows take several passes
            else:
                assert max(passes) == 1
    assert want[2].any()


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("span", SPANS)
def test_run_scan_on_crafted_chains(seed, span):
    """Random chains with runs shorter than a scan and hops anywhere
    (some upward), lanes that walk into position 0 with ``rem`` to spare
    (the root clamp hops it to itself), ``max_steps`` below the longest
    ``rem``, and lanes sorted by ``rem`` as ``entry_state`` sorts them
    (against both oracles) or not sorted at all (the reference's twin
    assumes sorted lanes, so against the plain version only)."""
    rng = np.random.default_rng(seed)
    T, NP, tm, Lr = 300, 48, 4, 9
    nxt = np.arange(-1, T - 1, dtype=np.int32)
    starts = rng.choice(np.arange(20, T), 40, replace=False)
    nxt[starts] = rng.integers(-1, T, 40)
    seq = rng.integers(0, NP - 6, T).astype(np.int32)
    M = 3 * tm
    pos = rng.integers(0, T, (M, Lr)).astype(np.int32)
    rem = rng.integers(0, 120, (M, Lr)).astype(np.int32)
    pos[:, 0] = rng.integers(0, 10, M)   # a straight run down to the root
    rem[:, 0] = rng.integers(12, 120, M)  # ... and steps left past it
    lo = rng.integers(0, NP // 2, (M, 1)).astype(np.int32)
    lo[:tm] = 0  # tile 0 never stops: its first lanes reach position 0
    hi = np.minimum(lo + rng.integers(0, NP, (M, 1)), NP).astype(np.int32)
    order = np.argsort(-rem, axis=1, kind="stable")
    for lanes_sorted in (True, False):
        lp, lr = pos, rem
        if lanes_sorted:
            lp = np.take_along_axis(pos, order, 1)
            lr = np.take_along_axis(rem, order, 1)
        args = dict(ti=np.asarray([2, 0], np.int32), lane_pos=lp,
                    lane_rem=lr, nxt2d=nxt.reshape(1, -1),
                    seq2d=seq.reshape(1, -1),
                    ssz2d=rng.integers(1, 20, (1, NP)).astype(np.int32),
                    rsz=rng.integers(1, 20, (M, 1)).astype(np.int32),
                    lo=lo, hi=hi)
        for max_steps in (int(rem.max()) + 5, 37, 1, 0):
            kw = dict(t=0.5, measure="overlap", max_steps=max_steps, tm=tm)
            want = plain(args, kw)
            if lanes_sorted:
                assert_same(reference(args, kw), want)
            for cols in (port_walk.walk_pass_cols(NP), 16):
                assert_same(scan_walk(*args.values(), cols=cols, span=span,
                                      **kw)[0], want)


def test_planned_run_scan_matches_planned_plain():
    """K6 is K1's rows over the live prefix of a device plan, written at
    each tile's own slot, with dead tiles zero."""
    args, kw, _ = table_operands("grown", 5, "jaccard", 0.5)
    args.pop("ti")
    hi = args["hi"].copy()
    hi[TM:2 * TM] = args["lo"][TM:2 * TM]  # tile 1 dies
    args["hi"] = hi
    ti_sorted, n_live = port_walk.plan_row_tiles_device(
        torch.tensor(args["lo"]), torch.tensor(hi), TM)
    want = port_walk.lfvt_walk_planned_ref(
        ti_sorted, n_live, *[torch.tensor(v) for v in args.values()], **kw)
    live = ti_sorted[:int(n_live)].numpy()
    got, _ = scan_walk(live, *args.values(), cols=16, **kw)
    m_tiles = ti_sorted.shape[0]
    assert 0 < len(live) < m_tiles
    for g, w in zip(got, want):
        full = np.zeros(w.shape, g.dtype)
        full[live] = g
        np.testing.assert_array_equal(full, w.numpy())


# ---------------------------------------------------------------------- #
# the hops a walk takes
# ---------------------------------------------------------------------- #
def walked_hops(flat):
    """Every hop the chains of ``flat`` take, as (row before, row after)
    arrays: each live entry walked from its position for its length."""
    live = flat.entry_len > 0
    pos = (flat.node_seq_off[flat.entry_node[live]]
           + flat.entry_off[live]).astype(np.int64)
    rem = flat.entry_len[live].astype(np.int64)
    before, after = [], []
    while len(pos):
        nxt = np.maximum(flat.seq_next[pos], 0)
        go = rem > 1
        before.append(flat.seq_row[pos[go]])
        after.append(flat.seq_row[nxt[go]])
        pos, rem = nxt[go], rem[go] - 1
    return np.concatenate(before), np.concatenate(after)


@pytest.mark.parametrize("seed", range(3))
def test_encode_hops_lower_the_row(seed):
    """Theorem 3.3 on ``encode()`` tables: every walked hop strictly
    lowers the row, so the kernel's stop at the first row below lo ends
    every in-window step."""
    S = SetCollection.from_ragged(zipf_sets(seed, 200, 20, 60), universe=60)
    before, after = walked_hops(S.sort_by_size().flat_lfvt())
    assert len(before) > 500
    assert (after < before).all()


def test_grown_table_hops_may_not_lower_the_row():
    """Tables grown by IncrementalLFVT keep appended rows at the tail and
    re-encode merged chains in size order: some walked hops raise the
    row. A run may not be searched by row id there; the run scan is held
    to the plain version on exactly such a table."""
    enc = IncrementalLFVT(SetCollection.from_ragged(
        zipf_sets(7, 60, 12), universe=UNIVERSE), capacity_grain=4)
    enc.append([np.arange(0, 14)])
    enc.append(zipf_sets(8, 20))
    assert enc.stats["merged_chains"]
    before, after = walked_hops(enc.flat)
    assert (after >= before).any() and (after < before).any()
    args, kw, _ = table_operands("grown", 7, "jaccard", 0.5)
    assert_same(scan_walk(*args.values(), cols=16, **kw)[0], plain(args, kw))


# ---------------------------------------------------------------------- #
# the host launch plan: shared count columns and column passes
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("np_cols,cols", [
    (0, 16), (1, 16), (16, 16), (17, 32), (128, 128), (1000, 1008),
    (port_walk.WALK_MAX_COLS, port_walk.WALK_MAX_COLS),
    (100_096, port_walk.WALK_MAX_COLS)])
def test_walk_pass_cols(np_cols, cols):
    assert port_walk.walk_pass_cols(np_cols) == cols


def test_walk_passes_cover_each_window_once():
    """At the launch's ``cols`` every window narrower than
    ``WALK_MAX_COLS`` takes one pass; a wider window takes two; an empty
    window one (its lanes still walk for the counters)."""
    rng = np.random.default_rng(0)
    NP = 100_096
    lo = rng.integers(0, NP, 500)
    hi = np.minimum(lo + rng.integers(-50, 30_000, 500), NP)
    cols = port_walk.walk_pass_cols(NP)
    assert cols % 16 == 0 and cols <= port_walk.WALK_MAX_COLS
    np.testing.assert_array_equal(port_walk.walk_passes(lo, hi, NP, cols), 1)
    np.testing.assert_array_equal(
        port_walk.walk_passes([5, 3, 0, 70_000], [60_000, 3, 0, 200_000],
                              NP, port_walk.WALK_MAX_COLS), [2, 1, 1, 1])


@pytest.mark.parametrize("np_cols", [16, 48, 1024, 57_344])
def test_launch_cols_hold_any_window_in_one_pass(np_cols):
    """Up to ``WALK_MAX_COLS`` columns, the launch's ``cols`` hold every
    window in ``[0, np_cols]`` in one pass, however its start sits
    against the 16-column chunks."""
    rng = np.random.default_rng(np_cols)
    lo = np.concatenate([np.arange(17), rng.integers(0, np_cols + 1, 500)])
    hi = np.concatenate([np.full(17, np_cols),
                         rng.integers(0, np_cols + 1, 500)])
    cols = port_walk.walk_pass_cols(np_cols)
    np.testing.assert_array_equal(
        port_walk.walk_passes(lo, hi, np_cols, cols), 1)
