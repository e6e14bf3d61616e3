"""Candidate-based competitor algorithms from the paper's evaluation (§5.3).

A numpy copy of the JAX package's ``core/baselines.py``. The paper's
baselines have no public code; like the authors, we implement them from
their original papers — here in vectorized numpy, instrumented to
report the quantities the paper plots: candidate-pair counts, verification
work and shuffle ("disk") bytes. All are *exact* joins; tests pin them to
the float64 brute-force oracle.

  allpairs_join    AllPairs [2]: length filter only, full verification
  ppjoin_join      PPJoin-style [35]: prefix filter + inverted index
  mr_rp_ppjoin     RIDPairsPPJoin / RP-PPJoin [31]: prefix-token routing
  fs_join          FS-Join [26]: vertical (segment) partitioning
  fasttelp_sj      FastTELP-SJ [11]: LFVT over the *merged* R∪S collection
"""
from __future__ import annotations

import numpy as np

from .join import cf_rs_join_lfvt
from .measures import get_measure
from .sets import SetCollection, length_filter_bounds

__all__ = ["allpairs_join", "ppjoin_join", "mr_rp_ppjoin", "fs_join",
           "fasttelp_sj"]

_HDR = 8  # per-record header bytes (set id + size), as in core.partition
_ELEM = 4


def _verify(Ri, Sj, t, measure="jaccard") -> bool:
    inter = len(np.intersect1d(Ri, Sj, assume_unique=True))
    return get_measure(measure).qualifies(inter, len(Ri), len(Sj), t)


# ---------------------------------------------------------------------- #
def allpairs_join(R: SetCollection, S: SetCollection, t: float,
                  stats: dict | None = None,
                  measure: str = "jaccard") -> set:
    """Length filter -> verify every surviving pair (candidate-based)."""
    s_sizes = S.sizes()
    out, candidates = set(), 0
    for i, Ri in enumerate(R.sets):
        if not len(Ri):
            continue
        lo, hi = length_filter_bounds(len(Ri), t, measure)
        for j in np.nonzero((s_sizes >= lo) & (s_sizes <= hi))[0]:
            candidates += 1
            if _verify(Ri, S.sets[j], t, measure):
                out.add((int(R.ids[i]), int(S.ids[j])))
    if stats is not None:
        stats["candidates"] = candidates
    return out


# ---------------------------------------------------------------------- #
def _freq_order(R: SetCollection, S: SetCollection) -> np.ndarray:
    """Global ascending-frequency element order (rarest first), as PPJoin."""
    universe = max(R.universe, S.universe)
    freq = np.zeros(universe, np.int64)
    for c in (R, S):
        for s in c.sets:
            freq[s] += 1
    # rank: stable order by (freq, element id)
    order = np.lexsort((np.arange(universe), freq))
    rank = np.empty(universe, np.int64)
    rank[order] = np.arange(universe)
    return rank


def _prefix(tokens_ranked: np.ndarray, size: int, t: float,
            measure: str = "jaccard") -> np.ndarray:
    """Prefix filter: first |x| - lb + 1 tokens in rank order, where lb is
    the measure's overlap lower bound over the size window (Jaccard:
    ceil(t·|x|); overlap measure: 1, i.e. no pruning power)."""
    k = size - get_measure(measure).prefix_min_overlap(size, t) + 1
    return tokens_ranked[:k]


def ppjoin_join(R: SetCollection, S: SetCollection, t: float,
                stats: dict | None = None,
                measure: str = "jaccard") -> set:
    """Prefix-filter candidate join with an inverted index over S prefixes."""
    rank = _freq_order(R, S)
    s_ranked = [np.sort(rank[s]) for s in S.sets]
    r_ranked = [np.sort(rank[s]) for s in R.sets]
    s_sizes = S.sizes()
    # index S prefixes
    index: dict[int, list[int]] = {}
    for j, sr in enumerate(s_ranked):
        if len(sr):
            for tok in _prefix(sr, len(sr), t, measure):
                index.setdefault(int(tok), []).append(j)
    out, candidates = set(), 0
    for i, rr in enumerate(r_ranked):
        if not len(rr):
            continue
        lo, hi = length_filter_bounds(len(rr), t, measure)
        seen: set[int] = set()
        for tok in _prefix(rr, len(rr), t, measure):
            for j in index.get(int(tok), ()):
                if j in seen or not (lo <= s_sizes[j] <= hi):
                    continue
                seen.add(j)
                candidates += 1
                if _verify(R.sets[i], S.sets[j], t, measure):
                    out.add((int(R.ids[i]), int(S.ids[j])))
    if stats is not None:
        stats["candidates"] = candidates
        stats["index_entries"] = sum(len(v) for v in index.values())
    return out


# ---------------------------------------------------------------------- #
def mr_rp_ppjoin(R: SetCollection, S: SetCollection, t: float,
                 n_shards: int, stats: dict | None = None,
                 measure: str = "jaccard") -> set:
    """RP-PPJoin [31]: stage-2 routes a full copy of each set per prefix
    token (token -> shard by hash); shards run PPJoin locally; results are
    deduped globally. Shuffle bytes grow with prefix replication — the
    paper's Table 3 effect."""
    rank = _freq_order(R, S)
    shard_r: list[list[int]] = [[] for _ in range(n_shards)]
    shard_s: list[list[int]] = [[] for _ in range(n_shards)]
    shuffle = 0
    for rows, coll, dest in ((shard_r, R, "r"), (shard_s, S, "s")):
        for row, sset in enumerate(coll.sets):
            if not len(sset):
                continue
            ranked = np.sort(rank[sset])
            shards = {int(tok) % n_shards
                      for tok in _prefix(ranked, len(ranked), t, measure)}
            for k in shards:
                rows[k].append(row)
                shuffle += len(sset) * _ELEM + _HDR
    out: set = set()
    candidates = 0
    for k in range(n_shards):
        if not shard_r[k] or not shard_s[k]:
            continue
        Rk = SetCollection([R.sets[i] for i in shard_r[k]], R.universe,
                           R.ids[shard_r[k]])
        Sk = SetCollection([S.sets[j] for j in shard_s[k]], S.universe,
                           S.ids[shard_s[k]])
        st: dict = {}
        out |= ppjoin_join(Rk, Sk, t, st, measure)
        candidates += st["candidates"]
    if stats is not None:
        stats["candidates"] = candidates
        stats["shuffle_bytes"] = shuffle
    return out


# ---------------------------------------------------------------------- #
def fs_join(R: SetCollection, S: SetCollection, t: float, n_shards: int,
            stats: dict | None = None, measure: str = "jaccard") -> set:
    """FS-Join [26]: split the (frequency-ordered) universe into vertical
    segments, shard by segment, emit per-segment partial intersections,
    then merge partials and verify. Intermediate volume = emitted partial
    records — the quantity that explodes at low thresholds (Table 3)."""
    rank = _freq_order(R, S)
    universe = max(R.universe, S.universe)
    seg_of = (rank * n_shards // max(universe, 1)).astype(np.int64)
    shuffle = 0
    partials: dict[tuple[int, int], int] = {}
    for k in range(n_shards):
        r_seg = [np.asarray(s)[seg_of[s] == k] for s in R.sets]
        s_seg = [np.asarray(s)[seg_of[s] == k] for s in S.sets]
        shuffle += sum(len(x) * _ELEM + (_HDR if len(x) else 0)
                       for x in r_seg + s_seg)
        # per-shard: inverted index over this segment's S tokens
        inv: dict[int, list[int]] = {}
        for j, ss in enumerate(s_seg):
            for tok in ss:
                inv.setdefault(int(tok), []).append(j)
        counts: dict[tuple[int, int], int] = {}
        for i, rs in enumerate(r_seg):
            for tok in rs:
                for j in inv.get(int(tok), ()):
                    counts[(i, j)] = counts.get((i, j), 0) + 1
        for pair, c in counts.items():
            partials[pair] = partials.get(pair, 0) + c
            shuffle += 12  # emitted partial record (i, j, count)
    out, candidates = set(), 0
    m = get_measure(measure)
    r_sizes, s_sizes = R.sizes(), S.sizes()
    for (i, j), inter in partials.items():
        candidates += 1
        if m.qualifies(inter, int(r_sizes[i]), int(s_sizes[j]), t):
            out.add((int(R.ids[i]), int(S.ids[j])))
    if stats is not None:
        stats["candidates"] = candidates
        stats["shuffle_bytes"] = shuffle
    return out


# ---------------------------------------------------------------------- #
def fasttelp_sj(R: SetCollection, S: SetCollection, t: float,
                stats: dict | None = None, measure: str = "jaccard") -> set:
    """FastTELP-SJ [11] adapted to R-S (as the paper does): one big tree
    over R∪S, self-join, keep cross pairs. The merged tree is the memory
    cost the paper criticizes."""
    merged = SetCollection(
        R.sets + S.sets,
        max(R.universe, S.universe),
        np.concatenate([R.ids, S.ids + 10**9]),
    )
    st: dict = {}
    pairs = cf_rs_join_lfvt(merged, merged, t, stats=st, measure=measure)
    out = {
        (r, s - 10**9) for (r, s) in pairs if r < 10**9 <= s
    }
    if stats is not None:
        stats.update(st)
        stats["merged_sets"] = len(merged)
    return out
