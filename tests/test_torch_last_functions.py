"""PyTorch port vs JAX package: the reference's last public functions.

* ``Measure.min_overlap`` on the four measures, exact integers, for
  every |r|, |s| in 0..40 at t in {0.5, 0.7, 0.9, 2/3};
* ``GlobalConfig.snapshot`` / ``restore``;
* ``tile_join.clear_s_rep_cache`` / ``clear_r_block_cache``: a join
  after either stages its side again;
* ``tile_join.onehot_counts`` and ``_onehot_qualify`` over -1-padded
  element lists, equal to the reference's on six shapes (a universe that
  is not a multiple of the 512-wide block, one under it, empty rows).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.core import tile_join as ref_tj
from repro.core.measures import MEASURES as REF_MEASURES
from repro_torch.core import tile_join as port_tj
from repro_torch.core.config import GlobalConfig, global_config
from repro_torch.core.measures import MEASURES as PORT_MEASURES

THRESHOLDS = (0.5, 0.7, 0.9, 2 / 3)


@pytest.mark.parametrize("t", THRESHOLDS)
@pytest.mark.parametrize("measure", sorted(PORT_MEASURES))
def test_min_overlap_matches_reference(measure, t):
    port, ref = PORT_MEASURES[measure], REF_MEASURES[measure]
    for r in range(41):
        for s in range(41):
            got = port.min_overlap(r, s, t)
            assert type(got) is int
            assert got == ref.min_overlap(r, s, t), (r, s)
            # the smallest qualifying overlap, where one fits in both sets
            if got <= min(r, s):
                assert port.qualifies(got, r, s, t)
                assert got == 1 or not port.qualifies(got - 1, r, s, t)


def test_config_snapshot_restore_round_trips():
    cfg = GlobalConfig()
    snap = cfg.snapshot()
    assert snap == vars(cfg) and snap is not vars(cfg)
    cfg.row_tile, cfg.guardrail_budget, cfg.fault = 8, 4096, "compact:oom"
    assert cfg.snapshot() != snap
    cfg.restore(snap)
    assert vars(cfg) == snap
    assert (cfg.row_tile, cfg.guardrail_budget, cfg.fault) == (
        global_config.row_tile, global_config.guardrail_budget,
        global_config.fault)


def _sets(seed=3, n=40, universe=200):
    rng = np.random.default_rng(seed)
    out = [np.sort(rng.choice(universe, int(rng.integers(2, 12)),
                              replace=False)) for _ in range(n)]
    return out


@pytest.mark.parametrize("method", ["lfvt", "popcount"])
def test_cache_clears_force_a_new_upload(method, monkeypatch):
    """The second join hits both caches; after ``clear_s_rep_cache`` S is
    staged again (for ``lfvt`` the table's arrays are copied anew), after
    ``clear_r_block_cache`` every R block is uploaded again."""
    monkeypatch.setattr(global_config, "planner_calibrate", False)
    sets = _sets()
    R = repro_torch.as_collection(sets[:30])
    S = repro_torch.as_collection(sets[10:]).sort_by_size()

    def join():
        st: dict = {}
        pairs = port_tj.cf_rs_join_device(R, S, 0.5, method=method,
                                          r_block=8, stats=st, device="cpu")
        return pairs, st

    first, st = join()
    assert first and not st["s_rep_cache_hit"] and st["r_rep_cache_hits"] == 0
    again, st = join()
    assert again == first and st["s_rep_cache_hit"]
    assert st["r_rep_cache_hits"] == st["r_blocks"] == 4
    if method == "lfvt":
        before = S.flat_lfvt().to_device("cpu").seq_row
    port_tj.clear_s_rep_cache()
    if method == "lfvt":
        assert S.flat_lfvt()._device == {}
    got, st = join()
    assert got == first and not st["s_rep_cache_hit"]
    assert st["r_rep_cache_hits"] == 4
    if method == "lfvt":
        after = S.flat_lfvt().to_device("cpu").seq_row
        assert after is not before and torch.equal(after, before)
    port_tj.clear_r_block_cache()
    got, st = join()
    assert got == first and st["s_rep_cache_hit"]
    assert st["r_rep_cache_hits"] == 0


#: (rows of R, rows of S, universe, largest set, measure, t)
ONEHOT_SHAPES = (
    (30, 45, 700, 40, "jaccard", 0.5),     # two blocks, the last ragged
    (1, 1, 1, 1, "cosine", 0.7),           # a one-element universe
    (9, 14, 300, 25, "dice", 2 / 3),       # under one block
    (20, 33, 1025, 60, "overlap", 0.9),    # one element past two blocks
    (12, 7, 512, 12, "jaccard", 0.9),      # exactly one block
    (25, 18, 1500, 30, "cosine", 0.5),     # every other row empty
)


def _padded_problem(m, n, universe, top, seed):
    rng = np.random.default_rng(seed)

    def draw(k, empty_every):
        return [np.sort(rng.choice(universe,
                                   0 if i % empty_every == 0 else
                                   int(rng.integers(1, top + 1)),
                                   replace=False)) for i in range(k)]

    empty = 2 if universe == 1500 else 5
    r = draw(m, empty)
    s = draw(n, 3) + r[:min(m, 4)]     # a few exact partners
    R = repro_torch.as_collection(r, universe)
    S = repro_torch.as_collection(s, universe)
    (rp, rs), (sp, ss) = R.padded(), S.padded()
    lo = rng.integers(0, len(s) // 2 + 1, m)
    hi = lo + rng.integers(0, len(s) + 1, m)
    return rp, rs, sp, ss, lo.astype(np.int64), hi.astype(np.int64)


@pytest.mark.parametrize("shape", ONEHOT_SHAPES,
                         ids=[f"{s[0]}x{s[1]}-U{s[2]}" for s in ONEHOT_SHAPES])
def test_onehot_counts_and_qualify_match_reference(shape):
    m, n, universe, top, measure, t = shape
    rp, rs, sp, ss, lo, hi = _padded_problem(m, n, universe, top, m + n)
    assert (rs == 0).any()
    want = np.asarray(ref_tj.onehot_counts(
        jnp.asarray(rp), jnp.asarray(rs), jnp.asarray(sp), jnp.asarray(ss),
        universe))
    tt = [torch.tensor(a) for a in (rp, rs, sp, ss)]
    got = port_tj.onehot_counts(*tt, universe)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    want_q = np.asarray(ref_tj._onehot_qualify(
        jnp.asarray(rp), jnp.asarray(rs), jnp.asarray(sp), jnp.asarray(ss),
        jnp.asarray(lo), jnp.asarray(hi), t=t, universe=universe,
        measure=measure))
    got_q = port_tj._onehot_qualify(*tt[:2], *tt[2:], torch.tensor(lo),
                                    torch.tensor(hi), t=t, universe=universe,
                                    measure=measure)
    assert got_q.dtype == torch.bool
    np.testing.assert_array_equal(got_q.numpy(), want_q)


def test_onehot_counts_in_row_groups(monkeypatch):
    """The one-hot staged eight rows at a time: still exact."""
    rp, rs, sp, ss, _, _ = _padded_problem(30, 45, 700, 40, 1)
    want = np.asarray(ref_tj.onehot_counts(
        *(jnp.asarray(a) for a in (rp, rs, sp, ss)), 700))
    monkeypatch.setitem(port_tj.STAGE_BYTES, "cpu", 8 * 512 * 40 * 8)
    got = port_tj.onehot_counts(*(torch.tensor(a) for a in (rp, rs, sp, ss)),
                                700)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() > 0


def test_exported():
    for name in ("onehot_counts", "clear_s_rep_cache", "clear_r_block_cache"):
        assert name in port_tj.__all__ and name in ref_tj.__all__
