"""Load-aware length-range partitioning (paper §4, Eq. 2–3) + hash baseline.

A numpy copy of the JAX package's ``core/partition.py``.

The map phase routes every ``S_j`` to the single shard owning its length
and every ``R_i`` to *all* shards whose S-length interval intersects the
per-measure size window (Lemma 3.1 generalized, DESIGN.md §8 — for
Jaccard ``[ceil(t|R|), floor(|R|/t)]``). Shard boundaries minimize
the heaviest shard load ``psi`` via the dynamic program of Eq. 2, where a
shard's load (Eq. 3) models its search phase (R elements x S sets in
range) plus its build phase (S elements in range).

This partitioner doubles as the framework's *straggler mitigation* for the
join: the slowest shard bounds the step, so minimizing max-load is
minimizing the straggler (paper Fig. 8; EXPERIMENTS.md §Join/partitioning).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .measures import SIZE_INF, get_measure
from .sets import SetCollection

__all__ = ["Partitioning", "load_aware_partition", "hash_partition", "route"]


@dataclasses.dataclass
class Partitioning:
    """Contiguous length intervals [lb_k, rb_k] per shard + routing rules."""

    intervals: list[tuple[int, int]]  # inclusive bounds, ascending
    t: float
    psi: float  # DP estimate of the heaviest shard load
    strategy: str = "load_aware"
    measure: str = "jaccard"

    @property
    def n_shards(self) -> int:
        return len(self.intervals)

    def s_shard(self, size: int) -> int:
        for k, (lb, rb) in enumerate(self.intervals):
            if lb <= size <= rb:
                return k
        # sizes outside every interval (can happen for hash/degenerate cases)
        return 0 if size < self.intervals[0][0] else self.n_shards - 1

    def r_shards(self, size: int) -> list[int]:
        lo, hi = get_measure(self.measure).size_window(size, self.t)
        hi = int(SIZE_INF) if hi is None else hi
        return [
            k for k, (lb, rb) in enumerate(self.intervals)
            if not (hi < lb or lo > rb)
        ]

    def shard_rows(self, R: SetCollection, S: SetCollection):
        """Routed row-index view: ``(s_rows, r_rows)`` lists, one int array
        per shard — the map phase without the byte accounting. The
        planner probes these to score each shard's method independently
        of the reduce drivers."""
        s_rows, r_rows, _ = route(R, S, self)
        return s_rows, r_rows


def _length_histograms(R: SetCollection, S: SetCollection):
    max_len = int(max(R.sizes().max(initial=1), S.sizes().max(initial=1)))
    Cr = np.bincount(R.sizes(), minlength=max_len + 1).astype(np.float64)
    Cs = np.bincount(S.sizes(), minlength=max_len + 1).astype(np.float64)
    return Cr, Cs, max_len


def _load(lb: int, rb: int, Cr: np.ndarray, Cs: np.ndarray, t: float,
          pref_i_cr: np.ndarray, pref_cs: np.ndarray, pref_i_cs: np.ndarray,
          measure: str = "jaccard") -> float:
    """Eq. 3 via prefix sums: search load + build load of shard [lb, rb].

    Eligible R sizes are those whose per-measure window reaches [lb, rb]:
    the window bounds are mutually inverse for all four measures, so the
    range is [lo(lb), hi(rb)] (Jaccard: [ceil(t·lb), floor(rb/t)]).
    """
    m = get_measure(measure)
    L = len(pref_cs) - 2  # max representable length
    r_lo = min(int(m.size_window(lb, t)[0]), L)
    hi = m.size_window(rb, t)[1]
    r_hi = L if hi is None else min(int(hi), L)
    r_elems = pref_i_cr[r_hi + 1] - pref_i_cr[r_lo] if r_hi >= r_lo else 0.0
    s_sets = pref_cs[rb + 1] - pref_cs[lb]
    s_elems = pref_i_cs[rb + 1] - pref_i_cs[lb]
    return r_elems * s_sets + s_elems


def load_aware_partition(R: SetCollection, S: SetCollection, t: float,
                         n_shards: int, measure: str = "jaccard") -> Partitioning:
    """Eq. 2 dynamic program over distinct S lengths (O(L^2 * l))."""
    m = get_measure(measure)
    Cr, Cs, max_len = _length_histograms(R, S)
    lengths = np.nonzero(Cs)[0]
    if len(lengths) == 0:
        return Partitioning([(1, max_len)], t, 0.0, measure=m.name)
    lmin, lmax = int(lengths[0]), int(lengths[-1])
    # prefix sums for O(1) Eq.3 evaluation
    i_arr = np.arange(len(Cr), dtype=np.float64)
    pref_i_cr = np.concatenate([[0.0], np.cumsum(i_arr * Cr)])
    pref_cs = np.concatenate([[0.0], np.cumsum(Cs)])
    pref_i_cs = np.concatenate([[0.0], np.cumsum(i_arr * Cs)])

    def load(lb, rb):
        return _load(lb, rb, Cr, Cs, t, pref_i_cr, pref_cs, pref_i_cs,
                     measure=m.name)

    # DP over candidate boundaries = the distinct occupied lengths
    cand = [int(x) for x in lengths]  # ascending
    K = len(cand)
    n_shards = min(n_shards, K)
    INF = float("inf")
    # psi[l][k]: best max-load splitting cand[0..k] into l shards
    psi = np.full((n_shards + 1, K), INF)
    cut = np.full((n_shards + 1, K), -1, dtype=np.int64)
    for k in range(K):
        psi[1][k] = load(lmin, cand[k])
    for l in range(2, n_shards + 1):
        for k in range(l - 1, K):
            for c in range(l - 2, k):  # last shard covers cand[c+1..k]
                v = max(psi[l - 1][c], load(cand[c] + 1, cand[k]))
                if v < psi[l][k]:
                    psi[l][k] = v
                    cut[l][k] = c
    # recover intervals
    intervals: list[tuple[int, int]] = []
    l, k = n_shards, K - 1
    hi = lmax
    while l > 1:
        c = int(cut[l][k])
        intervals.append((cand[c] + 1, hi))
        hi = cand[c]
        k, l = c, l - 1
    intervals.append((lmin, hi))
    intervals.reverse()
    return Partitioning(intervals, t, float(psi[n_shards][K - 1]),
                        measure=m.name)


def hash_partition(R: SetCollection, S: SetCollection, t: float,
                   n_shards: int, measure: str = "jaccard") -> Partitioning:
    """Paper §5.3.1 baseline: full S on every shard, R split evenly.

    Encoded as a single all-covering interval repeated; ``route`` special-
    cases the strategy.
    """
    _, _, max_len = _length_histograms(R, S)
    return Partitioning([(1, max_len)] * n_shards, t, float("nan"),
                        strategy="hash", measure=get_measure(measure).name)


def _grouped_rows(rows: np.ndarray, shards: np.ndarray, n: int):
    """Flat (row, shard) pairs -> per-shard row arrays, row order kept."""
    order = np.argsort(shards, kind="stable")
    per_shard = np.bincount(shards, minlength=n)
    return np.split(rows[order], np.cumsum(per_shard)[:-1])


def route(R: SetCollection, S: SetCollection, part: Partitioning):
    """Map phase: shard row arrays for S (one each) and R (one or more
    each).

    Returns (s_rows_per_shard, r_rows_per_shard, stats) — per-shard
    ``np.int64`` row-index arrays — where stats counts the exact shuffle
    volume (the paper's "disk usage" metric): 4 bytes per routed element
    id + 8 bytes per routed (set id, size) header.

    Fully vectorized: shard assignment is a searchsorted over the interval
    boundaries, replication runs are materialized with repeat/cumsum, and
    the per-shard arrays come from one stable grouping pass — no per-row
    Python loop or int boxing (collections are 10^5+ rows at bench scale).
    """
    n = part.n_shards
    s_sizes, r_sizes = S.sizes(), R.sizes()
    if part.strategy == "hash":
        # full S on every shard; R split round-robin
        rows_s = np.repeat(np.arange(len(S), dtype=np.int64), n)
        shards_s = np.tile(np.arange(n, dtype=np.int64), len(S))
        rows_r = np.arange(len(R), dtype=np.int64)
        shards_r = rows_r % n
    else:
        lbs = np.asarray([iv[0] for iv in part.intervals], dtype=np.int64)
        rbs = np.asarray([iv[1] for iv in part.intervals], dtype=np.int64)
        # S: the unique shard whose [lb, rb] holds the size (out-of-range
        # sizes clamp to the edge shards, matching Partitioning.s_shard)
        rows_s = np.arange(len(S), dtype=np.int64)
        shards_s = np.clip(np.searchsorted(rbs, s_sizes.astype(np.int64)),
                           0, n - 1)
        # R: every shard whose interval intersects the per-measure window
        lo, hi = get_measure(part.measure).size_window_arrays(
            r_sizes.astype(np.int64), part.t)
        k_lo = np.searchsorted(rbs, lo)                      # first rb >= lo
        k_hi = np.searchsorted(lbs, hi, side="right") - 1    # last lb <= hi
        reps = np.maximum(k_hi - k_lo + 1, 0)
        rows_r = np.repeat(np.arange(len(R), dtype=np.int64), reps)
        starts = np.concatenate([[0], np.cumsum(reps)])
        shards_r = (np.repeat(k_lo, reps)
                    + np.arange(len(rows_r), dtype=np.int64)
                    - np.repeat(starts[:-1], reps))
    s_groups = _grouped_rows(rows_s, shards_s, n)
    r_groups = _grouped_rows(rows_r, shards_r, n)
    elem_bytes = 4
    header = 8
    shuffle = int(
        elem_bytes * (int(s_sizes[rows_s].sum()) + int(r_sizes[rows_r].sum()))
        + header * (len(rows_s) + len(rows_r)))
    r_elems = np.bincount(shards_r, weights=r_sizes[rows_r], minlength=n)
    s_elems = np.bincount(shards_s, weights=s_sizes[rows_s], minlength=n)
    s_count = np.bincount(shards_s, minlength=n)
    loads = (r_elems * np.maximum(s_count, 1) + s_elems).astype(np.int64)
    stats = {
        "shuffle_bytes": shuffle,
        "shard_loads": [int(x) for x in loads],
        "max_load": int(loads.max(initial=0)),
        "r_replication": len(rows_r) / max(len(R), 1),
    }
    return s_groups, r_groups, stats
