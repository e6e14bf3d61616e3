"""PyTorch port vs JAX package: the one-hot family (K4, K5).

The plain PyTorch versions of ``onehot_join_live_tiled`` (K4) and
``onehot_join_tiled`` (K5) are held against the reference's Pallas
kernels run in interpret mode on the same padded operands, made with
numpy from a seed: masks and counts must be equal (tolerance 0). The
port's one-hot methods take the bitmap words, as its kernels do; the
membership product over them must equal the reference's padded-list
``onehot_counts``, also when it is taken in universe chunks.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.core import tile_join as ref_tj
from repro.kernels import onehot_join as ref_oj
from repro.kernels import ops as ref_ops
from repro_torch.core import tile_join as port_tj
from repro_torch.kernels import bitmap_join as port_bj
from repro_torch.kernels import onehot_join as port_oj
from repro_torch.kernels import ops as port_ops

MEASURES = ("jaccard", "cosine", "dice", "overlap")
THRESHOLDS = (0.5, 0.7, 0.9, 2 / 3)


def problem(seed, m, n, universe):
    """Bitmaps (a quarter of the bits set, a third of S copied from R),
    sizes, and random windows over a size-sorted S."""
    rng = np.random.default_rng(seed)
    W = max((universe + 31) // 32, 1)

    def words(rows):
        bm = (rng.integers(0, 2 ** 32, (rows, W), dtype=np.uint32)
              & rng.integers(0, 2 ** 32, (rows, W), dtype=np.uint32))
        if universe % 32:
            bm[:, -1] &= np.uint32((1 << (universe % 32)) - 1)
        return bm

    r_bm, s_bm = words(m), words(n)
    k = min(m, n) // 3
    s_bm[:k] = r_bm[:k]
    r_sz = np.bitwise_count(r_bm).sum(1).astype(np.int32)
    s_sz = np.bitwise_count(s_bm).sum(1).astype(np.int32)
    order = np.argsort(-s_sz, kind="stable")
    s_bm, s_sz = s_bm[order], s_sz[order]
    lo = rng.integers(0, max(n, 1), m).astype(np.int32)
    hi = np.minimum(lo + rng.integers(0, max(n, 1), m), n).astype(np.int32)
    return r_bm, r_sz, s_bm, s_sz, lo, hi


def assert_kernels_match(prob, t, measure, tiles=None):
    """K5 and K4 plain versions == the reference's interpreted Pallas
    kernels on the same padded operands; returns the pair count."""
    r_bm, r_sz, s_bm, s_sz, lo, hi = prob
    ref = ref_ops._prepare(jnp.asarray(r_bm), jnp.asarray(r_sz),
                           jnp.asarray(s_bm), jnp.asarray(s_sz),
                           jnp.asarray(lo), jnp.asarray(hi), tiles,
                           ref_oj.DEFAULT_TILES)
    port = port_ops._prepare(torch.tensor(r_bm.view(np.int32)), r_sz,
                             torch.tensor(s_bm.view(np.int32)), s_sz, lo,
                             hi, tiles, port_oj.DEFAULT_TILES)
    for a, b in zip(ref[:7], port[:7]):
        np.testing.assert_array_equal(np.asarray(a).view(np.int32),
                                      b.numpy())
    tls = port[7]
    assert ref[7] == tls
    want = ref_oj.onehot_join_tiled(*ref[:7], t=t, measure=measure,
                                    tiles=tls, interpret=True)
    got = port_oj.onehot_join_tiled(*port[:7], t=t, measure=measure,
                                    tiles=tls)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    TM, TN, _ = tls
    ti, tj = port_ops._live_tiles(port[4][:, 0].numpy(),
                                  port[5][:, 0].numpy(),
                                  port[0].shape[0] // TM,
                                  port[2].shape[0] // TN, TM, TN)
    if len(ti):
        want_m, want_c = ref_oj.onehot_join_live_tiled(
            jnp.asarray(ti), jnp.asarray(tj), *ref[:6], t=t,
            measure=measure, tiles=tls, interpret=True)
        got_m, got_c = port_oj.onehot_join_live_tiled(
            torch.from_numpy(ti), torch.from_numpy(tj), *port[:6], t=t,
            measure=measure, tiles=tls)
        np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
        np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
        assert int(got_c.sum()) == int(got.sum())
    return int(got.sum())


@pytest.mark.parametrize("t", THRESHOLDS)
@pytest.mark.parametrize("measure", MEASURES)
def test_plain_kernels_match_pallas(measure, t):
    prob = problem(12, 40, 140, 270)  # W = 9: not a multiple of TW
    assert assert_kernels_match(prob, t, measure) > 0


@pytest.mark.parametrize("m,n,universe,tiles", [
    (1, 1, 7, None),
    (17, 140, 257, None),
    (130, 260, 1025, None),     # (128, 256, 8): the default tiles
    (24, 300, 200, (8, 128, 1)),
    (24, 300, 200, (16, 128, 2)),
    (20, 300, 90, None),        # W = 3: (32, 256, 4)
    (20, 300, 90, (32, 128, 2)),
    # every (TM, TN) the CUDA kernel takes, ragged in both axes, at
    # W in {1, 3, 5, 9} words (not a multiple of its 4-word stage)
    (19, 300, 32, (8, 128, 1)),
    (35, 300, 96, (16, 128, 1)),
    (67, 300, 160, (32, 128, 1)),
    (131, 300, 288, (64, 128, 1)),
    (131, 300, 32, (128, 128, 1)),
    (19, 520, 96, (8, 256, 1)),
    (35, 520, 160, (16, 256, 1)),
    (67, 520, 288, (32, 256, 1)),
    (131, 520, 32, (64, 256, 1)),
    (260, 520, 96, (128, 256, 1)),
])
def test_plain_kernels_match_pallas_at_shapes(m, n, universe, tiles):
    prob = problem(m * 1000 + n, m, n, universe)
    assert_kernels_match(prob, 0.5, "jaccard", tiles)


def test_plain_kernels_match_pallas_on_full_rows():
    """Rows with every bit of an 8 192-element universe set (counts reach
    the universe) beside sparse ones, all windows open."""
    r_bm, r_sz, s_bm, s_sz, _, _ = problem(9, 130, 300, 8192)
    r_bm[::7] = 0xFFFFFFFF
    s_bm[::5] = 0xFFFFFFFF
    r_sz = np.bitwise_count(r_bm).sum(1).astype(np.int32)
    s_sz = np.bitwise_count(s_bm).sum(1).astype(np.int32)
    prob = (r_bm, r_sz, s_bm, s_sz, np.zeros(130, np.int32),
            np.full(130, 300, np.int32))
    assert assert_kernels_match(prob, 0.5, "jaccard") >= 19 * 60


def test_plain_kernels_match_pallas_with_many_row_tiles():
    """More live tiles in one column tile (138) than a wave of CTAs on the
    card (132): the order the CUDA kernel takes them in must not show."""
    r_bm, r_sz, s_bm, s_sz, _, _ = problem(10, 1100, 300, 32)
    prob = (r_bm, r_sz, s_bm, s_sz, np.zeros(1100, np.int32),
            np.full(1100, 300, np.int32))
    assert assert_kernels_match(prob, 0.5, "dice", (8, 128, 1)) > 0


@pytest.mark.parametrize("measure", MEASURES)
def test_exact_boundary_pair(measure):
    """f = 4 of |R| = |S| = 5 qualifies at t = 2/3 (Jaccard exactly)."""
    R = repro_torch.as_collection([[0, 1, 2, 3, 4], [7, 8]], universe=40)
    S = repro_torch.as_collection([[0, 1, 2, 3, 5], [7, 9, 30]], universe=40)
    prob = (R.bitmaps(), R.sizes(), S.bitmaps(), S.sizes(),
            np.zeros(2, np.int32), np.full(2, 2, np.int32))
    assert assert_kernels_match(prob, 2 / 3, measure) >= 1


def test_membership_counts_match_reference_onehot_counts():
    """The port's product over bitmap words equals the reference's
    padded-list ``onehot_counts`` (the port's own is held against it in
    ``test_torch_last_functions.py``)."""
    rng = np.random.default_rng(6)
    U = 700
    r = [rng.choice(U, size=int(rng.integers(0, 40)), replace=False)
         for _ in range(30)]
    s = [rng.choice(U, size=int(rng.integers(0, 40)), replace=False)
         for _ in range(45)] + r[:5]
    R, S = repro_torch.as_collection(r, U), repro_torch.as_collection(s, U)
    (rp, rs), (sp, ss) = R.padded(), S.padded()
    want = np.asarray(ref_tj.onehot_counts(jnp.asarray(rp), jnp.asarray(rs),
                                           jnp.asarray(sp), jnp.asarray(ss),
                                           U))
    got = port_oj.membership_counts(
        torch.tensor(R.bitmaps().view(np.int32)),
        torch.tensor(S.bitmaps().view(np.int32)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_membership_counts_in_chunks(monkeypatch):
    """Full words over 130 words (4 160 shared bits), the product taken in
    universe chunks of a few words each: still exact."""
    r = np.full((3, 130), 0xFFFFFFFF, np.uint32)
    r[1, ::2] = 0
    s = np.full((2, 130), 0xFFFFFFFF, np.uint32)
    want = np.array([[4160, 4160], [2080, 2080], [4160, 4160]], np.int32)
    monkeypatch.setitem(port_tj.STAGE_BYTES, "cpu",
                        4 * 32 * 3 * 7)  # 7 words per chunk
    got = port_oj.membership_counts(torch.tensor(r.view(np.int32)),
                                    torch.tensor(s.view(np.int32)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_coerce_bitmaps_packs_element_lists():
    """With ``universe`` given the operands are element lists: packed to
    the reference's words, then padded to one width."""
    rng = np.random.default_rng(8)
    r = [rng.choice(50, size=5, replace=False) for _ in range(4)]
    s = [rng.choice(100, size=7, replace=False) for _ in range(6)]
    R, S = repro_torch.as_collection(r, 50), repro_torch.as_collection(s, 100)
    rw, sw = ref_ops._coerce_bitmaps(jnp.asarray(R.padded()[0]),
                                     jnp.asarray(S.padded()[0]), 100)
    gr, gs = port_ops._coerce_bitmaps(torch.tensor(R.padded()[0]),
                                      torch.tensor(S.padded()[0]), 100)
    np.testing.assert_array_equal(gr.numpy().view(np.uint32), np.asarray(rw))
    np.testing.assert_array_equal(gs.numpy().view(np.uint32), np.asarray(sw))
    # bitmaps of two widths: the narrower is zero-padded
    br, bs = port_ops._coerce_bitmaps(torch.tensor(R.bitmaps().view(np.int32)),
                                      torch.tensor(S.bitmaps().view(np.int32)),
                                      None)
    assert br.shape == (4, 4) and bs.shape == (6, 4)
    assert not br[:, 2:].any()


def test_wrappers_use_the_plain_version_only_on_the_cpu():
    prob = problem(5, 20, 130, 100)
    r_bm, r_sz, s_bm, s_sz, lo, hi = prob
    port = port_ops._prepare(torch.tensor(r_bm.view(np.int32)), r_sz,
                             torch.tensor(s_bm.view(np.int32)), s_sz, lo, hi,
                             None, port_oj.DEFAULT_TILES)
    before = (port_oj.onehot_join_tiled.launches,
              port_oj.onehot_join_live_tiled.launches)
    port_oj.onehot_join_tiled(*port[:7], t=0.5, measure="jaccard",
                              tiles=port[7])
    one = torch.zeros(1, dtype=torch.int32)
    port_oj.onehot_join_live_tiled(one, one, *port[:6], t=0.5,
                                   measure="jaccard", tiles=port[7])
    assert (port_oj.onehot_join_tiled.launches,
            port_oj.onehot_join_live_tiled.launches) == before
    meta = [x.to("meta") for x in port[:6]]
    with pytest.raises(ValueError, match="no kernel for meta"):
        port_oj.onehot_join_live_tiled(one, one, *meta, t=0.5,
                                       measure="jaccard", tiles=port[7])


def test_cta_order_takes_live_tiles_column_by_column():
    """K4's CTA order: a permutation of the live tiles, column tile by
    column tile, row tiles ascending within each, ties kept stable."""
    rng = np.random.default_rng(11)
    ti = torch.tensor(rng.integers(0, 9, 200), dtype=torch.int32)
    tj = torch.tensor(rng.integers(0, 5, 200), dtype=torch.int32)
    order = port_oj.cta_order(ti, tj, 9)
    assert order.dtype == torch.int32
    assert sorted(order.tolist()) == list(range(200))
    key = (tj.long() * 9 + ti.long())[order.long()]
    assert bool((key[1:] >= key[:-1]).all())
    same = key[1:] == key[:-1]
    assert bool((order[1:][same] > order[:-1][same]).all())


@pytest.mark.parametrize("tiles,ok", [
    ((8, 128, 1), True), ((96, 256, 8), True), ((128, 256, 8), True),
    ((128, 64, 8), False), ((256, 256, 8), False), ((64, 512, 8), False),
])
def test_kernel_tile_rule(tiles, ok):
    """The one-hot kernels take 1 <= TM <= 128 rows by TN in {128, 256}
    (every tile ``pick_tiles`` gives); other tilings raise before any
    launch."""
    TM, TN, TW = tiles
    z = torch.zeros
    ops_ = (z((2 * TM, TW), dtype=torch.int32),
            z((2 * TM, 1), dtype=torch.int32),
            z((TN, TW), dtype=torch.int32), z((1, TN), dtype=torch.int32),
            z((2 * TM, 1), dtype=torch.int32),
            z((2 * TM, 1), dtype=torch.int32))
    if ok:
        assert port_bj._check_operands("onehot_join", "k", tiles,
                                       *ops_) == (2 * TM, TN, TW)
    else:
        with pytest.raises(ValueError, match="TN in"):
            port_bj._check_operands("onehot_join", "k", tiles, *ops_)


@pytest.mark.parametrize("W", [1, 3, 4, 9])
def test_quad_words_pads_the_one_hot_operands(W):
    """The one-hot kernels read words 4 at a time: their bitmaps are
    zero-padded to a multiple of 4 words before a launch (the counts do
    not change)."""
    rng = np.random.default_rng(W)
    r = torch.tensor(rng.integers(-2 ** 31, 2 ** 31, (5, W)),
                     dtype=torch.int32)
    s = torch.tensor(rng.integers(-2 ** 31, 2 ** 31, (7, W)),
                     dtype=torch.int32)
    pr, ps, w = port_oj._quad_words(r, s, W)
    assert w == -(-W // 4) * 4 and pr.shape == (5, w) and ps.shape == (7, w)
    assert pr.is_contiguous() and ps.is_contiguous()
    assert torch.equal(pr[:, :W], r) and not pr[:, W:].any()
    assert torch.equal(port_oj.membership_counts(pr, ps),
                       port_oj.membership_counts(r, s))
