"""PyTorch port vs JAX package: the MapReduce driver's loop path (2/2).

As ``test_torch_mr.py``, the same inputs through both packages with the
pairs and every stat in ``_mr_cases.STAT_KEYS`` equal: the kernel
methods (``kernel_bitmap``, ``kernel_onehot``; the reference runs its
Pallas kernels in interpret mode, so two calls a measure), both
strategies and pad modes, a tiny ``pair_capacity`` (regrows), empty
collections and empty shards, a mixed per-shard ``auto`` plan, the front
door (``repro_torch.join(n_shards=)``, ``DedupPipeline.filter_batch``),
``mesh=`` with a foreign mesh object and the MR kwarg lattice's error
texts.
"""
import numpy as np
import pytest

import repro
import repro_torch
from repro.core import distributed as ref_dist
from repro.core.config import global_config as ref_config
from repro.data.pipeline import DedupPipeline as RefPipeline
from repro_torch.core import distributed as port_dist
from repro_torch.core.config import global_config as port_config
from repro_torch.core.planner import PlannerError
from repro_torch.errors import MeshTypeError
from tests._mr_cases import (MEASURES, THRESHOLDS, assert_same_stats,
                             both, run_both, sample_sets)


@pytest.fixture(autouse=True)
def uncalibrated(monkeypatch):
    """Both planners score with ``DEFAULT_COEFFS``."""
    for cfg in (ref_config, port_config):
        monkeypatch.setattr(cfg, "planner_calibrate", False)


@pytest.fixture(scope="module")
def collections():
    return both(*sample_sets())


@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("method", ["kernel_bitmap", "kernel_onehot"])
def test_mr_kernel_methods_match_reference(collections, method, measure):
    """The reference's kernels run in interpret mode: two calls a measure,
    the thresholds rotating over the measures (each measure meets the
    exact-2/3 pair under one emit mode)."""
    k = MEASURES.index(measure)
    boundary = (len(collections[0]) - 1, len(collections[1]) - 1)
    for t, n_shards, emit in ((THRESHOLDS[k], 3, "pairs"),
                              (2 / 3 if k % 2 else THRESHOLDS[k - 1], 2,
                               "mask")):
        got, st = run_both(collections, t, n_shards, method=method,
                           measure=measure, emit=emit)
        assert got, (t, emit)
        if t == 2 / 3:
            assert boundary in got
        if emit == "pairs":
            assert 0 < st["live_tiles"] <= st["total_tiles"]


@pytest.mark.parametrize("method", ["lfvt", "popcount", "kernel_bitmap",
                                    "auto"])
@pytest.mark.parametrize("strategy", ["load_aware", "hash"])
def test_strategies_and_pads_match_reference(collections, strategy, method):
    for n_shards, pad in ((2, None), (8, None), (3, "global"),
                          (3, "bucket")):
        if pad is not None and method in ("lfvt", "auto"):
            continue  # pad= is refused on the loop lfvt path
        for emit in ("pairs", "mask"):
            run_both(collections, 0.5, n_shards, strategy=strategy,
                     method=method, emit=emit, pad=pad)


@pytest.mark.parametrize("method", ["lfvt", "lfvt_ref", "popcount",
                                    "onehot", "kernel_bitmap",
                                    "kernel_onehot"])
def test_tiny_pair_capacity_regrows(collections, monkeypatch, method):
    for cfg in (ref_config, port_config):  # capacity 1, not one grain
        monkeypatch.setattr(cfg, "pair_cap_grain", 1)
    _, st = run_both(collections, 0.5, 3, method=method, pair_capacity=1)
    assert st["regrows"] >= 1


@pytest.mark.parametrize("side", ["R", "S", "both"])
def test_empty_collections(side):
    r, s = sample_sets(n_r=10, n_s=9)
    r = [] if side in ("R", "both") else r
    s = [] if side in ("S", "both") else s
    for method in ("lfvt", "popcount", "auto"):
        got, st = run_both(both(r, s), 0.5, 4, method=method)
        assert got == set() and st["n_shards"] == 0


def test_empty_shards_match_reference():
    """8 shards over 3 distinct S sizes: the partitioner keeps 3, and the
    hash strategy's round-robin leaves R-less shards empty."""
    r = [np.arange(k % 3 + 2) for k in range(3)]
    s = [np.arange(k % 3 + 2) for k in range(12)]
    coll = both(r, s)
    for method in ("lfvt", "popcount", "kernel_bitmap"):
        for strategy in ("load_aware", "hash"):
            got, st = run_both(coll, 0.5, 8, method=method,
                               strategy=strategy)
            assert got
            assert st["n_shards"] == (3 if strategy == "load_aware" else 8)


def test_auto_mixes_shard_methods():
    """Many tiny sets over a small universe plus a block of large sets
    over a large one: the per-shard plan mixes popcount and lfvt."""
    rng = np.random.default_rng(3)
    small = [np.unique(rng.integers(0, 64, size=int(rng.integers(2, 5))))
             for _ in range(80)]
    large = [np.unique(rng.integers(0, 1 << 18, size=60)) for _ in range(12)]
    r = small + large
    s = small[::-1] + [np.unique(np.concatenate([x[:-2], x[:2] + 1]))
                       for x in large]
    coll = both(r, s)
    for emit in ("pairs", "mask"):
        got, st = run_both(coll, 0.5, 4, method="auto", emit=emit)
        assert set(st["shard_methods"]) == {"popcount", "lfvt"}
        assert got


# ---------------------------------------------------------------------- #
# the front door, the dedup pipeline and the kwarg lattice
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("method", ["auto", "lfvt", "kernel_onehot"])
@pytest.mark.parametrize("emit", ["pairs", "mask"])
def test_front_door_matches_reference(collections, method, emit):
    R, S, Rt, St = collections
    a = repro.join(R, S, 0.5, method=method, emit=emit, n_shards=4)
    b = repro_torch.join(Rt, St, 0.5, method=method, emit=emit, n_shards=4,
                         device="cpu")
    assert b.pairs == a.pairs and b.pairs
    assert b.plan.to_dict() == a.plan.to_dict()
    assert b.plan.driver == "mr"
    assert_same_stats(a.stats.raw, b.stats.raw)
    if emit == "mask":
        np.testing.assert_array_equal(b.mask, a.mask)


@pytest.mark.parametrize("method", ["popcount", "lfvt"])
def test_filter_batch_matches_reference(method):
    rng = np.random.default_rng(4)
    corpus = [np.unique(rng.integers(0, 50, size=8)) for _ in range(30)]
    docs = np.stack([np.resize(corpus[k], 8) for k in range(0, 30, 3)]
                    + [rng.integers(0, 50, size=8) for _ in range(6)])
    ref = RefPipeline(repro.as_collection(corpus), threshold=0.7,
                      n_shards=3, method=method)
    port = repro_torch.DedupPipeline(repro_torch.as_collection(corpus),
                                     threshold=0.7, n_shards=3,
                                     method=method, device="cpu")
    kept_a, st_a = ref.filter_batch(docs)
    kept_b, st_b = port.filter_batch(docs)
    np.testing.assert_array_equal(kept_b, kept_a)
    assert st_b["n_dropped"] == st_a["n_dropped"] >= 10
    assert_same_stats(st_a, st_b)
    assert port.stats is st_b


def test_mesh_raises_not_ported(collections):
    """``mesh=`` raised ``NotPortedError`` until the multi-device path
    was ported; now an object that is not the port's ``Mesh`` raises the
    named ``MeshTypeError`` in the driver and in the pipeline."""
    _, _, Rt, St = collections
    with pytest.raises(MeshTypeError, match="builtins.object"):
        port_dist.mr_cf_rs_join(Rt, St, 0.5, 2, mesh=object(), device="cpu")
    pipe = repro_torch.DedupPipeline(St, mesh=object(), device="cpu")
    with pytest.raises(MeshTypeError, match="make_host_mesh"):
        pipe.filter_batch(np.asarray([[1, 2, 3]]))


@pytest.mark.parametrize("kw", [
    dict(method="lfvt", pad="bucket"), dict(method="lfvt_ref", pad="global"),
    dict(method="popcount", schedule="planned"), dict(schedule="sideways"),
    dict(pad="diagonal"), dict(emit="mask", pair_capacity=8),
    dict(method="bogus"), dict(emit="dense"),
])
def test_mr_lattice_errors_match_reference(collections, kw):
    R, S, Rt, St = collections
    with pytest.raises(ValueError) as want:
        ref_dist.mr_cf_rs_join(R, S, 0.5, 2, **kw)
    with pytest.raises(PlannerError) as got:
        port_dist.mr_cf_rs_join(Rt, St, 0.5, 2, device="cpu", **kw)
    assert str(got.value) == str(want.value)


def test_front_door_mr_errors_match_reference(collections):
    R, S, Rt, St = collections
    for kw in (dict(n_shards=2, r_block=8), dict(n_shards=2, row_tile=8),
               dict(n_shards=2, method="lfvt", pad="bucket")):
        with pytest.raises(ValueError) as want:
            repro.join(R, S, 0.5, **kw)
        with pytest.raises(PlannerError) as got:
            repro_torch.join(Rt, St, 0.5, device="cpu", **kw)
        assert str(got.value) == str(want.value), kw
