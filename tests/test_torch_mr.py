"""PyTorch port vs JAX package: the MapReduce driver's loop path (1/2).

The same inputs (numpy seed) go through ``repro.core.distributed`` and
``repro_torch.core.distributed`` (``device="cpu"``): the partitioner's
intervals and ``psi`` for both strategies and all 4 measures, the map
phase's routed rows and stats, the packed ``shard_blocks`` byte for byte
(``pad="global"`` and ``"bucket"``), and ``mr_cf_rs_join`` itself — the
pair sets and every stat in ``_mr_cases.STAT_KEYS`` — for ``lfvt``,
``lfvt_ref``, ``popcount``, ``onehot`` and ``auto`` x 4 measures x t in
{0.5, 0.7, 0.9, 2/3} (at 1, 2, 3 and 8 shards, both emits), with the
exact-2/3 boundary pair of DESIGN.md §8 in the data. The kernel methods,
the strategies, regrows, empty inputs, the front door and the kwarg
lattice are in ``test_torch_mr_paths.py``. The reference plans with its
calibration off, so both planners score with ``DEFAULT_COEFFS``.
"""
import numpy as np
import pytest

from repro.core import distributed as ref_dist
from repro.core import partition as ref_part
from repro.core.config import global_config as ref_config
from repro_torch.core import distributed as port_dist
from repro_torch.core.config import global_config as port_config
from repro_torch.core import partition as port_part
from tests._mr_cases import (MEASURES, SHARD_COUNTS, THRESHOLDS, both,
                             run_both, same, sample_sets)


@pytest.fixture(autouse=True)
def uncalibrated(monkeypatch):
    """Both planners score with ``DEFAULT_COEFFS``."""
    for cfg in (ref_config, port_config):
        monkeypatch.setattr(cfg, "planner_calibrate", False)


@pytest.fixture(scope="module")
def collections():
    return both(*sample_sets())


# ---------------------------------------------------------------------- #
# map phase
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("strategy", ["load_aware", "hash"])
def test_partition_matches_reference(collections, strategy, measure):
    R, S, Rt, St = collections
    fns = {"load_aware": (ref_part.load_aware_partition,
                          port_part.load_aware_partition),
           "hash": (ref_part.hash_partition, port_part.hash_partition)}
    for t in THRESHOLDS:
        for k in SHARD_COUNTS:
            a = fns[strategy][0](R, S, t, k, measure=measure)
            b = fns[strategy][1](Rt, St, t, k, measure=measure)
            assert b.intervals == a.intervals, (t, k)
            assert same(b.psi, a.psi), (t, k)
            assert (b.strategy, b.measure, b.t) == (a.strategy, a.measure,
                                                    a.t)
            assert b.s_shard(7) == a.s_shard(7)
            assert b.r_shards(7) == a.r_shards(7)


@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("strategy", ["load_aware", "hash"])
def test_route_matches_reference(collections, strategy, measure):
    R, S, Rt, St = collections
    fn = "load_aware_partition" if strategy == "load_aware" else (
        "hash_partition")
    a = getattr(ref_part, fn)(R, S, 0.7, 3, measure=measure)
    b = getattr(port_part, fn)(Rt, St, 0.7, 3, measure=measure)
    sa, ra, sta = ref_part.route(R, S, a)
    sb, rb, stb = port_part.route(Rt, St, b)
    assert stb == sta
    for x, y in zip(sa + ra, sb + rb, strict=True):
        assert y.dtype == x.dtype and np.array_equal(x, y)
    assert [list(x) for x in b.shard_rows(Rt, St)[1]] == [
        list(x) for x in a.shard_rows(R, S)[1]]


@pytest.mark.parametrize("measure", ["jaccard", "overlap"])
@pytest.mark.parametrize("pad", ["global", "bucket"])
@pytest.mark.parametrize("strategy", ["load_aware", "hash"])
def test_shard_blocks_match_reference(collections, strategy, pad, measure):
    R, S, Rt, St = collections
    fn = "load_aware_partition" if strategy == "load_aware" else (
        "hash_partition")
    a = getattr(ref_part, fn)(R, S, 0.5, 8, measure=measure)
    b = getattr(port_part, fn)(Rt, St, 0.5, 8, measure=measure)
    ba, sta = ref_dist.shard_blocks(R, S, a, 0.5, pad=pad)
    bb, stb = port_dist.shard_blocks(Rt, St, b, 0.5, pad=pad)
    assert stb == sta
    assert len(bb) == len(ba) and (pad == "bucket" or len(bb) == 1)
    for x, y in zip(ba, bb):
        assert np.array_equal(x.shard_ids, y.shard_ids)
        assert (y.n_local, y.m_pad, y.n_pad, y.block_bytes()) == (
            x.n_local, x.m_pad, x.n_pad, x.block_bytes())
        for u, v in zip((*x.arrays, x.r_ids, x.s_ids),
                        (*y.arrays, y.r_ids, y.s_ids), strict=True):
            assert v.dtype == u.dtype and v.shape == u.shape
            assert v.tobytes() == u.tobytes()


def test_shard_blocks_reject_an_unknown_pad(collections):
    _, _, Rt, St = collections
    part = port_part.load_aware_partition(Rt, St, 0.5, 2)
    with pytest.raises(ValueError, match="unknown pad mode 'ragged'"):
        port_dist.shard_blocks(Rt, St, part, 0.5, pad="ragged")


# ---------------------------------------------------------------------- #
# the reduce: every method x measure x threshold x emit
# ---------------------------------------------------------------------- #
#: (t, n_shards, emit) of each call: every threshold at its own shard
#: count, both emits
GRID = tuple(zip(THRESHOLDS, SHARD_COUNTS, ("pairs", "mask") * 2))


@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("method", ["lfvt", "lfvt_ref", "popcount",
                                    "onehot", "auto"])
def test_mr_join_matches_reference(collections, method, measure):
    """Every (t, n_shards, emit) of ``GRID``; the exact-2/3 pair is found
    at t = 2/3."""
    boundary = (len(collections[0]) - 1, len(collections[1]) - 1)
    for t, n_shards, emit in GRID:
        got, st = run_both(collections, t, n_shards, method=method,
                           measure=measure, emit=emit)
        assert got, (t, emit)
        if t == 2 / 3:
            assert boundary in got
        if method == "lfvt":
            assert st["walk_steps"] > 0 and st["live_tiles"] > 0

