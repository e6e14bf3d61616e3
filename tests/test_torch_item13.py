"""PyTorch port vs JAX package: the join system's last public functions.

``data.synth.make_skew_dataset`` (byte-equal collections at the
benches' arguments), ``core.measures.measure_names``, the plain oracles
``kernels.ref.counts_ref`` / ``join_ref``, and the one-call wrappers of
``kernels.ops``: ``join_pairs`` for each family (``bitmap``: K2's plain
version; ``onehot``: K4's; ``lfvt``: the walk's; ``lfvt_ref``: the
whole-block walk), ``lfvt_join_pairs``, ``lfvt_walk_join_pairs``,
``lfvt_walk_join_mask`` and the re-exports ``round_capacity`` /
``PAIR_CAP_GRAIN``. Inputs are made with numpy from a seed; the
reference runs its Pallas kernels in interpret mode. Everything is held
exactly: pairs (capacity padding included), masks, counts and stats.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.core.measures import measure_names as ref_measure_names
from repro.core.tile_join import window_bounds
from repro.data.synth import make_skew_dataset as ref_skew
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro_torch.core.measures import measure_names
from repro_torch.data.synth import make_skew_dataset
from repro_torch.kernels import ops as port_ops
from repro_torch.kernels import ref as port_ref

MEASURES = ("jaccard", "cosine", "dice", "overlap")
THRESHOLDS = (0.5, 2 / 3, 0.9)
# stats both packages' one-call wrappers report
STATS = ("pair_count", "live_tiles", "total_tiles", "dense_mask_bytes",
         "pair_bytes", "counts_bytes", "output_bytes", "regrows",
         "walk_steps", "early_stops", "walk_vmem_tile_bytes")


def same_collection(a, b):
    assert len(a) == len(b) and a.universe == b.universe
    np.testing.assert_array_equal(a.ids, b.ids)
    for x, y in zip(a.sets, b.sets):
        assert x.dtype == y.dtype
        assert x.tobytes() == y.tobytes()


@pytest.mark.parametrize("args,kw", [
    ((500, 1200), dict(a=1.4, seed=11)),               # bench_scale
    ((120, 400), dict(a=1.4, seed=7)),                 # shuffle bytes
    ((160, 1 << 14), dict(a=1.4, seed=11, max_len=48,  # lfvt mesh
                          element_a=1.25)),
])
def test_make_skew_dataset_is_byte_equal(args, kw):
    (R, S), (r, s) = make_skew_dataset(*args, **kw), ref_skew(*args, **kw)
    same_collection(R, r)
    same_collection(S, s)
    assert max(R.sizes()) > 4 * np.median(R.sizes())   # the size skew


def test_measure_names_match_reference():
    assert measure_names() == ref_measure_names() == MEASURES


def bitmap_problem(seed=0, m=40, n=36, universe=150):
    rng = np.random.default_rng(seed)
    W = (universe + 31) // 32
    bits = rng.random((m + n, universe)) < 0.2
    bits[m:m + n // 3] = bits[:n // 3]      # shared rows: pairs at high t
    words = np.zeros((m + n, W), np.uint32)
    for a in range(universe):
        words[:, a // 32] |= bits[:, a].astype(np.uint32) << np.uint32(a % 32)
    sizes = bits.sum(1).astype(np.int32)
    lo = rng.integers(0, n, m).astype(np.int32)
    hi = np.minimum(lo + rng.integers(1, n, m), n).astype(np.int32)
    return words[:m], sizes[:m], words[m:], sizes[m:], lo, hi


@pytest.mark.parametrize("t", THRESHOLDS)
def test_counts_ref_and_join_ref_match_reference(t):
    r_bm, r_sz, s_bm, s_sz, lo, hi = bitmap_problem()
    want_c = ref_ref.counts_ref(jnp.asarray(r_bm), jnp.asarray(s_bm))
    for view in (np.int32, np.uint32):   # int32-held words, and uint32
        got_c = port_ref.counts_ref(torch.from_numpy(r_bm.view(view)),
                                    torch.from_numpy(s_bm.view(view)))
        assert got_c.dtype == torch.int32
        np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    want = ref_ref.join_ref(*map(jnp.asarray, (r_bm, r_sz, s_bm, s_sz, lo,
                                               hi)), t)
    got = port_ref.join_ref(torch.from_numpy(r_bm.view(np.int32)),
                            *map(torch.from_numpy, (r_sz,)),
                            torch.from_numpy(s_bm.view(np.int32)),
                            *map(torch.from_numpy, (s_sz, lo, hi)), t)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.any() and not got.all()


def join_problem(t, measure, seed=3, n_r=48, n_s=40, universe=120):
    """Skewed ragged sets (S shares a prefix of R) -> the reference's and
    the port's S collections (size-sorted), R, and Lemma-3.1 windows."""
    rng = np.random.default_rng(seed)
    r = [np.unique(rng.integers(0, universe,
                                int(min(18, 1 + rng.zipf(1.4)))))
         for _ in range(n_r)]
    s = r[:n_s // 3] + [np.unique(np.concatenate(
        [x, rng.integers(0, universe, 2)])) for x in r[n_s // 3:n_s]]
    Rr = repro.as_collection(r, universe=universe)
    Sr = repro.as_collection(s, universe=universe).sort_by_size()
    Sp = repro_torch.as_collection(s, universe=universe).sort_by_size()
    lo, hi = window_bounds(Rr.sizes(), Sr.sizes(), t, measure)
    return Rr, Sr, Sp, lo, hi


def both_calls(method, t, measure):
    """(reference args, port args) of ``join_pairs(method, ...)``."""
    Rr, Sr, Sp, lo, hi = join_problem(t, measure)
    if method in ("bitmap", "onehot"):
        W = (Sr.universe + 31) // 32
        r_bm, s_bm = Rr.bitmaps(W), Sr.bitmaps(W)
        r_sz, s_sz = Rr.sizes().astype(np.int32), Sr.sizes().astype(np.int32)
        ref = (jnp.asarray(r_bm), jnp.asarray(r_sz), jnp.asarray(s_bm),
               jnp.asarray(s_sz), jnp.asarray(lo), jnp.asarray(hi))
        port = (torch.tensor(r_bm.view(np.int32)), r_sz,
                torch.tensor(s_bm.view(np.int32)), s_sz, lo, hi)
        return ref, port
    r_pad, r_sz = Rr.padded()
    return ((Sr.flat_lfvt(), r_pad, r_sz, lo, hi),
            (Sp.flat_lfvt(), torch.tensor(r_pad), r_sz, lo, hi))


def same_stats(got, want):
    for k in STATS:
        assert (k in got) == (k in want), k
        if k in want:
            assert got[k] == want[k], k


@pytest.mark.parametrize("method", ["bitmap", "onehot", "lfvt", "lfvt_ref"])
@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("t", THRESHOLDS)
def test_join_pairs_matches_reference(method, measure, t):
    ref_args, port_args = both_calls(method, t, measure)
    st_ref: dict = {}
    st: dict = {}
    want, n_want = ref_ops.join_pairs(method, *ref_args, t, stats=st_ref,
                                      measure=measure)
    got, n = port_ops.join_pairs(method, *port_args, t, stats=st,
                                 measure=measure)
    assert n == n_want
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    same_stats(st, st_ref)
    if t < 0.9:
        assert n > 0


@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("t", THRESHOLDS)
def test_lfvt_one_call_wrappers_match_reference(measure, t):
    """``lfvt_walk_join_mask`` (mask and walk stats), and the named
    ``lfvt_walk_join_pairs`` / ``lfvt_join_pairs`` under a one-pair
    capacity hint."""
    ref_args, port_args = both_calls("lfvt", t, measure)
    st_ref: dict = {}
    st: dict = {}
    want = ref_ops.lfvt_walk_join_mask(*ref_args, t, measure=measure,
                                       stats=st_ref)
    got = port_ops.lfvt_walk_join_mask(*port_args, t, measure=measure,
                                       stats=st)
    assert got.dtype == bool
    np.testing.assert_array_equal(got, want)
    same_stats(st, st_ref)
    for name in ("lfvt_walk_join_pairs", "lfvt_join_pairs"):
        st_ref, st = {}, {}
        want, n_want = getattr(ref_ops, name)(*ref_args, t, capacity=1,
                                              stats=st_ref, measure=measure)
        got, n = getattr(port_ops, name)(*port_args, t, capacity=1,
                                         stats=st, measure=measure)
        assert n == n_want
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        same_stats(st, st_ref)


def test_reexports_and_unknown_method():
    assert port_ops.PAIR_CAP_GRAIN == ref_ops.PAIR_CAP_GRAIN
    for n in (0, 1, 128, 129, 1000):
        assert port_ops.round_capacity(n) == ref_ops.round_capacity(n)
    with pytest.raises(ValueError, match="unknown pair-emission method"):
        port_ops.join_pairs("dense", None)
