"""PyTorch port vs JAX package: the bitmap popcount family (K2, K3).

The plain PyTorch versions of ``bitmap_join_live_tiled`` (K2) and
``bitmap_join_tiled`` (K3) are held against the reference's Pallas
kernels run in interpret mode, as ``tests/test_kernels.py`` runs them,
on the same padded operands made with numpy from a seed: masks and
counts must be equal (booleans and integers, tolerance 0). So are the
pieces around them: ``SetCollection.bitmaps``, ``popcount_counts``,
``popcount_row_block``, ``pick_tiles``, ``_tile_skip_mask``,
``_live_tiles``, ``_compact_mask`` and the popcount join of one block.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.core import tile_join as ref_tj
from repro.kernels import bitmap_join as ref_bj
from repro.kernels import ops as ref_ops
from repro_torch.core import tile_join as port_tj
from repro_torch.kernels import bitmap_join as port_bj
from repro_torch.kernels import ops as port_ops

MEASURES = ("jaccard", "cosine", "dice", "overlap")
THRESHOLDS = (0.5, 0.7, 0.9, 2 / 3)


def words(rng, rows, W, universe):
    """(rows, W) uint32 bitmaps, a quarter of the bits set (the high bit
    included), none at or past ``universe``."""
    bm = (rng.integers(0, 2 ** 32, (rows, W), dtype=np.uint32)
          & rng.integers(0, 2 ** 32, (rows, W), dtype=np.uint32))
    if universe % 32:
        bm[:, -1] &= np.uint32((1 << (universe % 32)) - 1)
    return bm


def problem(seed, m, n, universe, sort_s=True):
    """Bitmaps, sizes and Lemma-3.1-like windows for an (m, n) block."""
    rng = np.random.default_rng(seed)
    W = max((universe + 31) // 32, 1)
    r_bm, s_bm = words(rng, m, W, universe), words(rng, n, W, universe)
    # a few S rows equal to R rows, so the high thresholds find pairs
    k = min(m, n) // 3
    s_bm[:k] = r_bm[:k]
    r_sz = np.bitwise_count(r_bm).sum(1).astype(np.int32)
    s_sz = np.bitwise_count(s_bm).sum(1).astype(np.int32)
    if sort_s:
        order = np.argsort(-s_sz, kind="stable")
        s_bm, s_sz = s_bm[order], s_sz[order]
    lo = rng.integers(0, max(n, 1), m).astype(np.int32)
    hi = np.minimum(lo + rng.integers(0, max(n, 1), m), n).astype(np.int32)
    return r_bm, r_sz, s_bm, s_sz, lo, hi


def boundary_problem():
    """|R| = |S| = 5, f = 4: Jaccard exactly 2/3 (DESIGN.md §8)."""
    R = repro_torch.as_collection([[0, 1, 2, 3, 4], [7, 8]], universe=40)
    S = repro_torch.as_collection([[0, 1, 2, 3, 5], [7, 9, 30]], universe=40)
    r_bm, s_bm = R.bitmaps(), S.bitmaps()
    r_sz, s_sz = R.sizes(), S.sizes()
    lo = np.zeros(2, np.int32)
    hi = np.full(2, 2, np.int32)
    return r_bm, r_sz, s_bm, s_sz, lo, hi


def padded_both(prob, defaults, tiles=None):
    """The same padded operands for the reference (jnp, uint32 words) and
    the port (torch, int32 words), plus the skip mask and live tiles."""
    r_bm, r_sz, s_bm, s_sz, lo, hi = prob
    ref = ref_ops._prepare(jnp.asarray(r_bm), jnp.asarray(r_sz),
                           jnp.asarray(s_bm), jnp.asarray(s_sz),
                           jnp.asarray(lo), jnp.asarray(hi), tiles, defaults)
    port = port_ops._prepare(torch.tensor(r_bm.view(np.int32)), r_sz,
                             torch.tensor(s_bm.view(np.int32)), s_sz, lo,
                             hi, tiles, defaults)
    # operands: rb, r_sz, sb, s_sz, lo, hi (+ skip), all equal bit for bit
    for a, b in zip(ref[:7], port[:7]):
        np.testing.assert_array_equal(np.asarray(a).view(np.int32),
                                      b.numpy())
    assert ref[7] == port[7]
    TM, TN, _ = port[7]
    lo_p, hi_p = port[4][:, 0].numpy(), port[5][:, 0].numpy()
    m_tiles, n_tiles = port[0].shape[0] // TM, port[2].shape[0] // TN
    ti, tj = port_ops._live_tiles(lo_p, hi_p, m_tiles, n_tiles, TM, TN)
    want_ti, want_tj = ref_ops._live_tiles(lo_p, hi_p, m_tiles, n_tiles, TM,
                                           TN)
    np.testing.assert_array_equal(ti, want_ti)
    np.testing.assert_array_equal(tj, want_tj)
    return ref, port, ti, tj


def assert_kernels_match(prob, t, measure, tiles=None):
    """K3 and K2 plain versions == the reference's interpreted Pallas
    kernels on the same padded operands; returns the pair count."""
    ref, port, ti, tj = padded_both(prob, ref_bj.DEFAULT_TILES, tiles)
    tls = port[7]
    want = ref_bj.bitmap_join_tiled(*ref[:7], t=t, measure=measure,
                                    tiles=tls, interpret=True)
    got = port_bj.bitmap_join_tiled(*port[:7], t=t, measure=measure,
                                    tiles=tls)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if len(ti) == 0:
        return int(got.sum())
    want_m, want_c = ref_bj.bitmap_join_live_tiled(
        jnp.asarray(ti), jnp.asarray(tj), *ref[:6], t=t, measure=measure,
        tiles=tls, interpret=True)
    got_m, got_c = port_bj.bitmap_join_live_tiled(
        torch.from_numpy(ti), torch.from_numpy(tj), *port[:6], t=t,
        measure=measure, tiles=tls)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    assert int(got_c.sum()) == int(got.sum())  # skipped tiles hold no pair
    return int(got.sum())


@pytest.mark.parametrize("t", THRESHOLDS)
@pytest.mark.parametrize("measure", MEASURES)
def test_plain_kernels_match_pallas(measure, t):
    prob = problem(11, 40, 140, 270)  # W = 9: not a multiple of TW
    assert assert_kernels_match(prob, t, measure) > 0


@pytest.mark.parametrize("m,n,universe,tiles", [
    (1, 1, 7, None),
    (17, 140, 257, None),
    (130, 260, 1025, None),
    (300, 300, 1280, None),      # (256, 256, 8): the default tiles
    (24, 300, 200, (8, 128, 1)),
    (24, 300, 200, (16, 128, 2)),
    (20, 300, 90, None),         # W = 3: (32, 256, 4)
    (20, 300, 90, (32, 128, 2)),
])
def test_plain_kernels_match_pallas_at_shapes(m, n, universe, tiles):
    prob = problem(m * 1000 + n, m, n, universe)
    assert_kernels_match(prob, 0.5, "jaccard", tiles)


@pytest.mark.parametrize("measure", MEASURES)
def test_exact_boundary_pair(measure):
    """f = 4 of |R| = |S| = 5 qualifies at t = 2/3 in every measure (at
    Jaccard exactly on the boundary)."""
    assert assert_kernels_match(boundary_problem(), 2 / 3, measure) >= 1


def test_bitmaps_match_reference():
    rng = np.random.default_rng(3)
    for universe in (1, 31, 32, 100, 1000):
        sets = [rng.choice(universe, size=int(rng.integers(0, min(30, universe)
                                                             + 1)),
                           replace=False) for _ in range(25)]
        for words_ in (None, max((universe + 31) // 32, 1) + 3):
            want = repro.as_collection(sets, universe).bitmaps(words_)
            got = repro_torch.as_collection(sets, universe).bitmaps(words_)
            assert got.dtype == np.uint32
            np.testing.assert_array_equal(got, want)
    C = repro_torch.as_collection([[1, 2]], 64)
    assert C.bitmaps() is C.bitmaps()  # memoized per W
    assert not C.bitmaps().flags.writeable
    assert repro_torch.as_collection([], 64).bitmaps().shape == (0, 2)


def test_pack_bitmaps_matches_reference():
    rng = np.random.default_rng(3)
    sets = [rng.choice(100, size=rng.integers(1, 30), replace=False)
            for _ in range(20)] + [[99, 31, 63, 0]]
    C = repro_torch.as_collection(sets, universe=100)
    padded = C.padded()[0]
    want = np.asarray(ref_ops._pack_bitmaps(jnp.asarray(padded), 100))
    got = port_ops._pack_bitmaps(torch.tensor(padded), 100)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), C.bitmaps())


@pytest.mark.parametrize("m,n,W", [(1, 1, 1), (7, 13, 5), (64, 200, 40),
                                   (300, 40, 2), (3, 4, 80)])
def test_popcount_counts_matches_reference(m, n, W):
    rng = np.random.default_rng(m + n + W)
    r = rng.integers(0, 2 ** 32, (m, W), dtype=np.uint32)
    s = rng.integers(0, 2 ** 32, (n, W), dtype=np.uint32)
    # every bit, the sign bit of each word included, in one cell
    r[0] = s[0] = 0xFFFFFFFF
    want = np.asarray(ref_tj.popcount_counts(jnp.asarray(r), jnp.asarray(s)))
    got = port_tj.popcount_counts(torch.tensor(r.view(np.int32)),
                                  torch.tensor(s.view(np.int32)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0, 0] == 32 * W


def test_popcount_counts_stays_in_its_budget(monkeypatch):
    """A budget of a few cells still gives the same counts."""
    rng = np.random.default_rng(9)
    r = rng.integers(0, 2 ** 32, (9, 6), dtype=np.uint32).view(np.int32)
    s = rng.integers(0, 2 ** 32, (11, 6), dtype=np.uint32).view(np.int32)
    want = port_tj.popcount_counts(torch.tensor(r), torch.tensor(s))
    monkeypatch.setitem(port_tj.STAGE_BYTES, "cpu", 8 * 3 * 4)
    got = port_tj.popcount_counts(torch.tensor(r), torch.tensor(s))
    assert torch.equal(got, want)


def test_popcount_row_block_and_pick_tiles_match_reference():
    from repro.kernels import onehot_join as ref_oj
    for m in (1, 5, 300, 1024, 5000):
        for n in (1, 1023, 1024, 100_000):
            assert port_tj.popcount_row_block(m, n) == \
                ref_tj.popcount_row_block(m, n)
    for defaults in (ref_bj.DEFAULT_TILES, ref_oj.DEFAULT_TILES):
        for m in (1, 8, 9, 20, 100, 129, 1024):
            for n in (1, 128, 129, 300, 100_000):
                for w in (1, 2, 3, 5, 9, 1363):
                    assert port_ops.pick_tiles(m, n, w, defaults) == \
                        ref_ops.pick_tiles(m, n, w, defaults)
    assert port_bj.DEFAULT_TILES == ref_bj.DEFAULT_TILES


def test_tile_skip_mask_matches_reference():
    rng = np.random.default_rng(4)
    tm, tn, m_tiles, n_tiles = 8, 128, 6, 5
    lo = rng.integers(0, tn * n_tiles, tm * m_tiles).astype(np.int32)
    hi = np.minimum(lo + rng.integers(0, 200, len(lo)),
                    tn * n_tiles).astype(np.int32)
    lo[:tm] = hi[:tm] = 0  # a tile of empty windows
    want = np.asarray(ref_ops._tile_skip_mask(jnp.asarray(lo), jnp.asarray(hi),
                                              m_tiles, n_tiles, tm, tn))
    got = port_ops._tile_skip_mask(torch.tensor(lo), torch.tensor(hi),
                                   m_tiles, n_tiles, tm, tn)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[0].all() and not want.all()
    ti, tj = port_ops._live_tiles(lo, hi, m_tiles, n_tiles, tm, tn)
    np.testing.assert_array_equal(np.stack(np.nonzero(want == 0)),
                                  np.stack([ti, tj]))
    with pytest.raises(ValueError, match="row_tile"):
        port_ops._live_tiles(lo[:-1], hi[:-1], m_tiles, n_tiles, tm, tn)


@pytest.mark.parametrize("size", [0, 3, 40, 128])
def test_compact_mask_matches_reference(size):
    rng = np.random.default_rng(size)
    mask = rng.random((9, 13)) < 0.3
    want = np.asarray(ref_tj._compact_mask(jnp.asarray(mask), size=size))
    got = port_tj._compact_mask(torch.from_numpy(mask), size=size)
    assert got.dtype == torch.int32 and got.shape == (size, 2)
    np.testing.assert_array_equal(got.numpy(), want)
    if size > mask.sum():
        assert (got[int(mask.sum()):] == -1).all()  # the capacity padding
    assert int(port_tj._mask_total(torch.from_numpy(mask))) == int(mask.sum())


@pytest.mark.parametrize("measure", MEASURES)
def test_popcount_qualify_matches_reference(measure):
    r_bm, r_sz, s_bm, s_sz, lo, hi = problem(21, 33, 70, 300)
    want = np.asarray(ref_tj._popcount_qualify(
        jnp.asarray(r_bm), jnp.asarray(r_sz), jnp.asarray(s_bm),
        jnp.asarray(s_sz), jnp.asarray(lo), jnp.asarray(hi), t=0.5,
        measure=measure))
    got = port_tj._popcount_qualify(
        torch.tensor(r_bm.view(np.int32)), torch.tensor(r_sz),
        torch.tensor(s_bm.view(np.int32)), torch.tensor(s_sz),
        torch.tensor(lo), torch.tensor(hi), t=0.5, measure=measure)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any()


def test_wrappers_use_the_plain_version_only_on_the_cpu():
    """CPU tensors take the plain version and count no launch; a tensor on
    another device raises instead of falling back."""
    prob = problem(5, 20, 130, 100)
    _, port, ti, tj = padded_both(prob, ref_bj.DEFAULT_TILES)
    before = (port_bj.bitmap_join_tiled.launches,
              port_bj.bitmap_join_live_tiled.launches)
    port_bj.bitmap_join_tiled(*port[:7], t=0.5, measure="jaccard",
                              tiles=port[7])
    port_bj.bitmap_join_live_tiled(torch.from_numpy(ti), torch.from_numpy(tj),
                                   *port[:6], t=0.5, measure="jaccard",
                                   tiles=port[7])
    assert (port_bj.bitmap_join_tiled.launches,
            port_bj.bitmap_join_live_tiled.launches) == before
    meta = [x.to("meta") for x in port[:7]]
    with pytest.raises(ValueError, match="no kernel for meta"):
        port_bj.bitmap_join_tiled(*meta, t=0.5, measure="jaccard",
                                  tiles=port[7])
