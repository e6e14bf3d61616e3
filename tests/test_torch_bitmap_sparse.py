"""The schedule of the port's K2/K3 kernels, on the CPU.

K2/K3 (``csrc/bitmap_join.cu``) visit only the words that hold a member:
S comes compressed (``bitmap_join.compress_s``: per column its nonzero
words as (word index, word) pairs, in 32-column slabs), each tile's rows
are taken 16 at a time in window order (``bitmap_join.window_order``),
and a group's CTA counts, per column of its window span, the column's
pairs whose word lies in the union of the group's nonzero words. The
kernels run only on the card; here ``schedule_model`` repeats that
schedule in plain PyTorch, and its masks and counts must equal
``_popcount_qualify``'s (the port's plain versions) and the JAX
package's Pallas kernels run in interpret mode, bit for bit (booleans and
integers, tolerance 0), on operands made from a seed with numpy. Also:
the compressed S expands back to its sheet, the row order stays inside
each tile, the join driver caches the compressed S beside the padded
sheet, and a launch takes a view of that sheet instead of a copy.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.kernels import bitmap_join as ref_bj
from repro.kernels import ops as ref_ops
from repro_torch.core import tile_join as port_tj
from repro_torch.core.sets import SetCollection
from repro_torch.kernels import bitmap_join as port_bj
from repro_torch.kernels import ops as port_ops

MEASURES = ("jaccard", "cosine", "dice", "overlap")
THRESHOLDS = (0.5, 0.7, 0.9, 2 / 3)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bits set in each int32-held uint32 word -> int32 of x's shape."""
    bits = (x.long() & 0xFFFFFFFF)[..., None] >> torch.arange(32)
    return (bits & 1).sum(-1, dtype=torch.int32)


def expand(sp: port_bj.SparseWords, n: int) -> torch.Tensor:
    """``SparseWords`` -> the (n, W) sheet it was built from."""
    out = torch.zeros((n, sp.words), dtype=torch.int32)
    for c in range(n):
        at = sp.offsets[c // 32] + 32 * torch.arange(int(sp.counts[c])) + (
            c % 32)
        out[c, sp.pairs[at, 0].long()] = sp.pairs[at, 1]
    return out


def schedule_model(rb, r_sz, sp, s_sz, lo, hi, *, t, measure, tiles,
                   skip=None, live=None, slice_=port_bj.UNION_SLICE):
    """K3 (``skip`` given: the dense (M, N) mask) or K2 (``live`` = the
    live tiles: (L, TM, TN) masks and (L, 1) counts) as the kernels
    schedule it: per tile, the rows in ``window_order`` 16 at a time; a
    group's columns are its non-empty windows' span inside the tile
    (none for a skipped tile); its union of nonzero words is staged
    ``slice_`` words at a time; each column adds, per pair of its
    compressed S whose word is staged, popc(R row word & word) to each
    row's count; then the predicate and the row's own window."""
    TM, TN, _ = tiles
    M, N = rb.shape[0], s_sz.shape[1]
    order = port_bj.window_order(lo, hi, TM).long()
    if live is None:
        todo = [(i, j, None) for i in range(M // TM) for j in range(N // TN)
                if not skip[i, j]]
        out = torch.zeros((M, N), dtype=torch.bool)
    else:
        todo = [(i, j, l) for l, (i, j) in enumerate(zip(*live))]
        out = torch.zeros((len(todo), TM, TN), dtype=torch.bool)
    for i, j, l in todo:
        for r0 in range(0, TM, port_bj.GROUP_ROWS):
            rows = order[i * TM + r0:i * TM + min(r0 + port_bj.GROUP_ROWS,
                                                  TM)]
            r_lo, r_hi = lo[rows, 0], hi[rows, 0]
            full = r_lo < r_hi
            if not full.any():
                continue
            c_lo = max(j * TN, int(r_lo[full].min()))
            c_hi = min((j + 1) * TN, int(r_hi[full].max()))
            if c_lo >= c_hi:
                continue
            cols = torch.arange(c_lo, c_hi)
            cnt = sp.counts[cols].long()
            k = torch.arange(int(cnt.max()))
            valid = k[None, :] < cnt[:, None]
            at = torch.where(valid, sp.offsets[cols // 32][:, None]
                             + 32 * k[None, :] + (cols % 32)[:, None], 0)
            word, bits = sp.pairs[at, 0].long(), sp.pairs[at, 1]
            union = torch.nonzero((rb[rows] != 0).any(0))[:, 0]
            acc = torch.zeros((len(rows), len(cols)), dtype=torch.int32)
            for s0 in range(0, len(union), slice_):
                part = union[s0:s0 + slice_]
                slot_of = torch.full((rb.shape[1],), -1, dtype=torch.long)
                slot_of[part] = torch.arange(len(part))
                slot = torch.where(valid, slot_of[word], -1)
                staged = rb[rows][:, part][:, slot.clamp(min=0)]
                acc += (popcount32(staged & bits[None]) * (slot >= 0)).sum(
                    -1, dtype=torch.int32)
            ok = port_tj.qualify(acc, r_sz[rows, 0], s_sz[0, cols], t,
                                 measure)
            ok &= (cols[None, :] >= r_lo[:, None]) & (
                cols[None, :] < r_hi[:, None])
            if l is None:
                out[rows[:, None], cols[None, :]] = ok
            else:
                out[l, (rows - i * TM)[:, None], (cols - j * TN)[None, :]] = ok
    if live is None:
        return out
    return out, out.sum(dim=(1, 2), dtype=torch.int32).reshape(-1, 1)


def sparse_sets(seed, n_r=40, n_s=300, universe=2000):
    """Zipf-skewed sets over a wide universe (most words of a row zero),
    with: S sharing R's first rows verbatim and perturbed (pairs at every
    threshold), the exact-2/3 pair (|R| = |S| = 5 sharing 4), empty sets
    on both sides, and an S set holding every element, so one column has
    every word set."""
    rng = np.random.default_rng(seed)
    r = [np.unique(rng.zipf(1.3, size=int(rng.integers(1, 40))) % universe)
         for _ in range(n_r - 2)]
    r += [np.arange(5), np.array([], np.int64)]
    s = r[:8] + [np.unique(np.concatenate([b, rng.integers(0, universe, 2)]))
                 for b in r[8:16]]
    s += [np.array([0, 1, 2, 3, 5]), np.arange(universe),
          np.array([], np.int64)]
    s += [np.unique(rng.zipf(1.3, size=int(rng.integers(1, 40))) % universe)
          for _ in range(n_s - len(s))]
    return (SetCollection.from_ragged(r, universe=universe),
            SetCollection.from_ragged(s, universe=universe).sort_by_size())


def operands(R, Ss, t, measure, tiles):
    """The padded operands of the port and of the reference, equal bit for
    bit, with the skip mask and the live tiles."""
    W = max((R.universe + 31) // 32, 1)
    r_bm, s_bm = R.bitmaps(W), Ss.bitmaps(W)
    lo, hi = port_tj.window_bounds(R.sizes(), Ss.sizes(), t, measure)
    lo, hi = lo.astype(np.int32), hi.astype(np.int32)
    port = port_ops._prepare(torch.tensor(r_bm.view(np.int32)), R.sizes(),
                             torch.tensor(s_bm.view(np.int32)), Ss.sizes(),
                             lo, hi, tiles, port_bj.DEFAULT_TILES)
    ref = ref_ops._prepare(jnp.asarray(r_bm), jnp.asarray(R.sizes()),
                           jnp.asarray(s_bm), jnp.asarray(Ss.sizes()),
                           jnp.asarray(lo), jnp.asarray(hi), tiles,
                           ref_bj.DEFAULT_TILES)
    for a, b in zip(ref[:7], port[:7]):
        np.testing.assert_array_equal(np.asarray(a).view(np.int32),
                                      b.numpy())
    TM, TN, _ = port[7]
    ti, tj = port_ops._live_tiles(port[4][:, 0].numpy(),
                                  port[5][:, 0].numpy(),
                                  port[0].shape[0] // TM,
                                  port[2].shape[0] // TN, TM, TN)
    return port, ref, (torch.from_numpy(ti), torch.from_numpy(tj))


@pytest.mark.parametrize("t", THRESHOLDS)
@pytest.mark.parametrize("measure", MEASURES)
def test_schedule_model_matches_plain_and_pallas(measure, t):
    """The model of K3 and K2 == the port's plain versions == the JAX
    package's interpreted Pallas kernels; at 2/3 the boundary pair is in
    the mask."""
    R, Ss = sparse_sets(11)
    port, ref, live = operands(R, Ss, t, measure, (24, 128, 1))
    ops_, skip, tls = port[:6], port[6], port[7]
    sp = port_bj.compress_s(ops_[2])
    kw = dict(t=t, measure=measure, tiles=tls)
    got = schedule_model(*ops_[:2], sp, *ops_[3:], skip=skip, **kw)
    assert torch.equal(got, port_bj.bitmap_join_tiled_ref(*ops_, skip, **kw))
    want = ref_bj.bitmap_join_tiled(*ref[:7], interpret=True, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got_m, got_c = schedule_model(*ops_[:2], sp, *ops_[3:], live=live, **kw)
    want_m, want_c = ref_bj.bitmap_join_live_tiled(
        jnp.asarray(live[0].numpy()), jnp.asarray(live[1].numpy()),
        *ref[:6], interpret=True, **kw)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    assert int(got_c.sum()) == int(got.sum()) > 0
    if t == 2 / 3:
        row = len(R) - 2                       # [0, 5)
        col = int(np.nonzero([len(s) == 5 and s[-1] == 5
                              for s in Ss.sets])[0][0])
        assert got[row, col]


@pytest.mark.parametrize("tiles,slice_", [
    ((256, 256, 8), port_bj.UNION_SLICE),   # the defaults: one group tile
    ((8, 128, 1), 3),                       # groups of 8 rows, 3-word slices
    ((40, 160, 2), 1),                      # groups of 16, 16 and 8 rows
])
def test_schedule_model_at_tilings(tiles, slice_):
    """Other tilings (groups shorter than 16 rows, a TN that is not a
    power of two) and union slices down to one word give the plain
    versions' masks and counts."""
    R, Ss = sparse_sets(12, n_r=70, n_s=330)
    port, _, live = operands(R, Ss, 0.5, "jaccard", tiles)
    ops_, skip, tls = port[:6], port[6], port[7]
    sp = port_bj.compress_s(ops_[2])
    kw = dict(t=0.5, measure="jaccard", tiles=tls)
    got = schedule_model(*ops_[:2], sp, *ops_[3:], skip=skip,
                         slice_=slice_, **kw)
    assert torch.equal(got, port_bj.bitmap_join_tiled_ref(*ops_, skip, **kw))
    got_m, got_c = schedule_model(*ops_[:2], sp, *ops_[3:], live=live,
                                  slice_=slice_, **kw)
    want_m, want_c = port_bj.bitmap_join_live_tiled_ref(*live, *ops_, **kw)
    assert torch.equal(got_m, want_m) and torch.equal(got_c, want_c)
    assert int(got.sum()) > 0


def test_schedule_model_honours_a_hand_made_skip():
    """A skip flag on a tile that the windows meet leaves it all False,
    as the reference's kernel does."""
    R, Ss = sparse_sets(13)
    port, ref, _ = operands(R, Ss, 0.5, "jaccard", (8, 128, 1))
    ops_, skip, tls = port[:6], port[6].clone(), port[7]
    paired = port_bj.bitmap_join_tiled_ref(*ops_, skip, t=0.5,
                                           measure="jaccard", tiles=tls)
    i, j = (int(x) for x in torch.nonzero(paired)[0])
    skip[i // tls[0], j // tls[1]] = 1
    kw = dict(t=0.5, measure="jaccard", tiles=tls)
    got = schedule_model(*ops_[:2], port_bj.compress_s(ops_[2]), *ops_[3:],
                         skip=skip, **kw)
    want = ref_bj.bitmap_join_tiled(*ref[:6], jnp.asarray(skip.numpy()),
                                    interpret=True, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got[i, j] and int(got.sum()) < int(paired.sum())


@pytest.mark.parametrize("n,W", [(2, 1), (45, 3), (64, 1368), (70, 5)])
def test_compress_s_expands_to_its_sheet(n, W):
    """Expanding the lists gives back the sheet bit for bit (sign bits
    included); counts are the nonzero words a column, slabs of 32 columns
    hold 32 x their largest count slots, slot-major, the unused ones
    (0, 0); empty columns and a column of every word set included."""
    rng = np.random.default_rng(n * W)
    sheet = rng.integers(0, 2 ** 32, (n, W), dtype=np.uint32)
    sheet[rng.random((n, W)) < 0.9] = 0
    sheet[0] = 0                              # an empty column
    sheet[-1] = 0xFFFFFFFF                    # every word set
    x = torch.tensor(sheet.view(np.int32))
    sp = port_bj.compress_s(x)
    nc = -(-n // 32) * 32
    assert sp.words == W and sp.counts.dtype == torch.int32
    assert sp.counts.shape == (nc,) and sp.offsets.shape == (nc // 32 + 1,)
    assert sp.offsets.dtype == torch.int64 and sp.pairs.dtype == torch.int32
    want_counts = np.zeros(nc, np.int32)
    want_counts[:n] = (sheet != 0).sum(1)
    np.testing.assert_array_equal(sp.counts.numpy(), want_counts)
    assert sp.counts[n - 1] == W and sp.counts[0] == 0
    slab = want_counts.reshape(-1, 32).max(1) * 32
    np.testing.assert_array_equal(sp.offsets.numpy(),
                                  np.concatenate([[0], np.cumsum(slab)]))
    assert sp.pairs.shape == (int(slab.sum()), 2)
    assert torch.equal(expand(sp, n), x)
    for c in range(n):                        # word indices ascend
        at = sp.offsets[c // 32] + 32 * torch.arange(int(sp.counts[c])) + (
            c % 32)
        assert bool((sp.pairs[at, 0].diff() > 0).all())
    used = torch.zeros(sp.pairs.shape[0], dtype=torch.bool)
    for c in range(n):
        used[sp.offsets[c // 32] + 32 * torch.arange(int(sp.counts[c]))
             + c % 32] = True
    assert not sp.pairs[~used].any()


def test_compress_s_of_no_columns():
    sp = port_bj.compress_s(torch.zeros((0, 4), dtype=torch.int32))
    assert sp.counts.shape == (0,) and sp.pairs.shape == (0, 2)
    assert sp.offsets.tolist() == [0] and sp.words == 4


@pytest.mark.parametrize("tm", [8, 16, 24, 256])
def test_window_order_is_stable_inside_each_tile(tm):
    """Each tile's rows, by window start, ties in row order, empty windows
    (the padding's [0, 0) and any lo == hi) last; never across tiles."""
    rng = np.random.default_rng(tm)
    M = 3 * tm
    lo = rng.integers(0, 50, M)
    hi = np.where(rng.random(M) < 0.2, lo, lo + rng.integers(1, 9, M))
    lo[-5:] = hi[-5:] = 0
    order = port_bj.window_order(torch.tensor(lo).reshape(-1, 1),
                                 torch.tensor(hi).reshape(-1, 1), tm)
    assert order.dtype == torch.int32
    order = order.numpy()
    for i in range(3):
        got = order[i * tm:(i + 1) * tm]
        rows = np.arange(i * tm, (i + 1) * tm)
        key = np.where(lo[rows] < hi[rows], lo[rows], 2 ** 31)
        np.testing.assert_array_equal(
            got, rows[np.argsort(key, kind="stable")])


def test_join_caches_the_compressed_s(monkeypatch):
    """``_s_device_rep(S, "sparse", ...)`` builds the compressed S once,
    from the padded sheet it caches beside it, and a repeated call reuses
    it. The join asks for it only on the card: on the CPU the popcount
    methods run their plain versions, which never read it, and the
    one-hot family never needs it."""
    R, Ss = sparse_sets(14)
    S = SetCollection.from_ragged(list(Ss.sets), universe=Ss.universe)
    built = []
    real = port_bj.compress_s
    monkeypatch.setattr(port_bj, "compress_s",
                        lambda x: built.append(x) or real(x))
    first = repro_torch.join(R, S, 0.5, method="popcount", device="cpu")
    for method in ("kernel_bitmap", "onehot"):
        again = repro_torch.join(R, S, 0.5, method=method, device="cpu")
        assert again.pairs == first.pairs and first.pairs, method
    W = max((S.universe + 31) // 32, 1)
    entry = port_tj._S_REP_CACHE[S]
    assert not built and ("sparse", W, "cpu") not in entry
    sheet = entry[("bitmap", W, "cpu")]
    cpu = torch.device("cpu")
    st: dict = {}
    _, sp, _, _ = port_tj._s_device_rep(S, "sparse", W, cpu, st)
    assert not st["s_rep_cache_hit"]
    assert len(built) == 1 and built[0] is sheet
    st = {}
    assert port_tj._s_device_rep(S, "sparse", W, cpu, st)[1] is sp
    assert st["s_rep_cache_hit"] and len(built) == 1
    assert port_tj._s_device_rep(S, "bitmap", W, cpu)[1] is sheet
    # the sheet is padded as the launches pad it, its rows past |S| zero
    _, TN, TW = port_ops.pick_tiles(1, len(S), W, port_bj.DEFAULT_TILES)
    assert sheet.shape == (-(-len(S) // TN) * TN, -(-W // TW) * TW)
    assert not sheet[len(S):].any()
    assert torch.equal(expand(sp, sheet.shape[0]), sheet)


def test_a_padded_sheet_is_not_copied_per_block():
    """``_pad_operands`` takes a view of a sheet already padded to the
    tiles (n from the S sizes), and gives the operands and mask it gives
    for the unpadded sheet."""
    R, Ss = sparse_sets(15, n_s=200)
    W = max((R.universe + 31) // 32, 1)
    r_bm = torch.tensor(R.bitmaps(W).view(np.int32))
    s_bm = torch.tensor(Ss.bitmaps(W).view(np.int32))
    sheet = port_ops.pad_sheet(s_bm)
    lo, hi = port_tj.window_bounds(R.sizes(), Ss.sizes(), 0.5)
    args = (r_bm, R.sizes())
    a = port_ops._pad_operands(*args, s_bm, Ss.sizes(), lo, hi, None,
                               port_bj.DEFAULT_TILES)
    b = port_ops._pad_operands(*args, sheet, Ss.sizes(), lo, hi, None,
                               port_bj.DEFAULT_TILES)
    assert b[2].data_ptr() == sheet.data_ptr()
    assert a[6:] == b[6:] and a[8] == len(Ss)
    for x, y in zip(a[:6], b[:6]):
        assert torch.equal(x, y)
    got = port_ops.bitmap_join(r_bm, R.sizes(), sheet, Ss.sizes(), lo, hi,
                               0.5)
    want = port_ops.bitmap_join(r_bm, R.sizes(), s_bm, Ss.sizes(), lo, hi,
                                0.5)
    assert got.shape == (len(R), len(Ss)) and torch.equal(got, want)


def test_launch_refuses_what_the_kernels_do_not_take():
    """Before any launch: a W past ``MAX_WORDS`` (the word -> slot map's
    room in shared memory) and a compressed S that does not cover the
    operands raise named ``ValueError``s; ``sparse_smem_bytes`` at
    ``MAX_WORDS`` fits a CTA."""
    assert port_bj.sparse_smem_bytes(port_bj.MAX_WORDS) <= 232448 - 1024
    assert port_bj.sparse_smem_bytes(port_bj.MAX_WORDS + 8) > 232448 - 1024
    W = port_bj.MAX_WORDS + 8
    z = torch.zeros
    args = (z((8, W), dtype=torch.int32), z((8, 1), dtype=torch.int32),
            z((32, W), dtype=torch.int32), z((1, 32), dtype=torch.int32),
            z((8, 1), dtype=torch.int32), z((8, 1), dtype=torch.int32),
            z((1, 1), dtype=torch.int32))
    kw = dict(t=0.5, measure="jaccard", tiles=(8, 32, 8), s_sparse=None)
    with pytest.raises(ValueError, match="MAX_WORDS"):
        port_bj._launch_sparse("bitmap_join_tiled", None, *args, **kw)
    sp = port_bj.compress_s(z((32, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="s_sparse holds 32 columns of 4"):
        port_bj._check_sparse("K3", sp, 64, 4, torch.device("cpu"))
    with pytest.raises(ValueError, match="must be a SparseWords"):
        port_bj._check_sparse("K3", (sp.counts,), 32, 4,
                              torch.device("cpu"))
    with pytest.raises(ValueError, match="the kernel takes TN a multiple"):
        port_bj._launch_sparse("bitmap_join_tiled", None, *args[:2],
                               z((48, W), dtype=torch.int32),
                               z((1, 48), dtype=torch.int32), *args[4:],
                               t=0.5, measure="jaccard", tiles=(8, 48, 8),
                               s_sparse=None)
