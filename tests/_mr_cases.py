"""Shared inputs and checks of the MapReduce differential tests
(``test_torch_mr.py``, ``test_torch_mr_paths.py``): the same sets go
through ``repro.core.distributed`` and ``repro_torch.core.distributed``
(``device="cpu"``), and the pairs and every stat in ``STAT_KEYS`` must be
equal."""
import math

import numpy as np

import repro
import repro_torch
from repro.core import distributed as ref_dist
from repro_torch.core import distributed as port_dist

MEASURES = ("jaccard", "cosine", "dice", "overlap")
THRESHOLDS = (0.5, 0.7, 0.9, 2 / 3)
SHARD_COUNTS = (1, 2, 3, 8)
STAT_KEYS = (
    "intervals", "psi", "shuffle_bytes", "shard_loads", "max_load",
    "r_replication", "result_pairs", "pair_bytes", "reduce_bytes",
    "dense_mask_bytes", "reduce_mask_peak_bytes",
    "reduce_intermediate_peak_bytes", "shard_block_bytes",
    "shard_block_bytes_per_shard", "pad_waste_max", "pad_waste_mean",
    "n_buckets", "regrows", "live_tiles", "total_tiles", "walk_steps",
    "early_stops", "walk_vmem_tile_bytes", "plan", "shard_methods", "pad",
    "n_shards", "emit", "measure", "retries", "degradations",
    "faults_injected", "tasks_resumed", "guardrail_splits", "backoff_total")
#: |R| = |S| = 5 with 4 shared elements: Jaccard exactly 2/3, and at
#: least 2/3 in every other measure (DESIGN.md §8)
BOUNDARY = (np.arange(200, 205), np.array([200, 201, 202, 203, 205]))


def sample_sets(seed=5, n_r=60, n_s=44, universe=90):
    """Zipf-skewed R; S shares a prefix of R verbatim and perturbs the
    rest, so every measure finds pairs; plus the exact-2/3 pair."""
    rng = np.random.default_rng(seed)
    r = [np.unique(rng.integers(0, universe,
                                size=int(min(16, 1 + rng.zipf(1.4)))))
         for _ in range(n_r)]
    s = r[:n_s // 3] + [
        np.unique(np.concatenate([b, rng.integers(0, universe, 2)]))
        for b in r[n_s // 3:n_s]]
    return r + [BOUNDARY[0]], s + [BOUNDARY[1]]


def both(r, s):
    """(reference R, S, port R, S) collections of the same sets."""
    return (repro.as_collection(r), repro.as_collection(s),
            repro_torch.as_collection(r), repro_torch.as_collection(s))


def same(a, b) -> bool:
    """Equality that holds NaN equal to NaN (``psi`` of the hash
    partitioner)."""
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (math.isnan(a) and math.isnan(b))
    return a == b


def assert_same_stats(a: dict, b: dict) -> None:
    for k in STAT_KEYS:
        assert (k in a) == (k in b), k
        if k in a:
            assert same(a[k], b[k]), (k, a[k], b[k])


def run_both(coll, t, n_shards, **kw):
    R, S, Rt, St = coll
    a: dict = {}
    b: dict = {}
    want = ref_dist.mr_cf_rs_join(R, S, t, n_shards, stats=a, **kw)
    got = port_dist.mr_cf_rs_join(Rt, St, t, n_shards, stats=b,
                                  device="cpu", **kw)
    assert got == want
    assert_same_stats(a, b)
    return got, b

