"""Synthetic join corpora mimicking the paper's 7 datasets (numpy only).

A copy of the JAX package's generators, so the same ``seed`` yields the
same collections in both packages. Table-1 statistics drive them:
per-dataset (collection size, mean/max set length, universe size, Zipf
exponent). ``scale`` multiplies the collection size only; universe,
length distribution and skew stay as specified. ``make_skew_dataset``
draws Zipf-sized sets (the shard-skew stressor of the benches), and
``docs_to_sets`` turns token documents into element sets for the dedup
pipeline. ``TokenStream`` is the language-model trainer's
deterministic-seek token source.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.sets import SetCollection

__all__ = ["DATASETS", "make_join_dataset", "make_skew_dataset",
           "docs_to_sets", "TokenStream"]


@dataclasses.dataclass(frozen=True)
class JoinDatasetSpec:
    name: str
    n_sets: int           # |R| = |S| at scale=1.0 (paper Table 1, scaled)
    universe: int
    mean_len: float
    max_len: int
    zipf_a: float         # element popularity skew
    len_sigma: float      # lognormal length spread ("concentration range")


# scaled-down analogues of the paper's Table 1 datasets
DATASETS = {
    "dblp": JoinDatasetSpec("dblp", 5000, 27500, 15.6, 203, 1.3, 0.35),
    "kosarak": JoinDatasetSpec("kosarak", 5000, 3600, 11.6, 2497, 1.6, 0.9),
    "livej": JoinDatasetSpec("livej", 15000, 43600, 36.2, 300, 1.4, 0.5),
    "querylog": JoinDatasetSpec("querylog", 6000, 6000, 1.0, 1, 1.1, 0.0),
    "enron": JoinDatasetSpec("enron", 3000, 7900, 141.6, 3162, 1.5, 1.0),
    "orkut": JoinDatasetSpec("orkut", 14000, 72000, 120.0, 14193, 1.4, 1.1),
    "facebook": JoinDatasetSpec("facebook", 3000, 3110, 20.6, 775, 1.2, 0.25),
}


def _sample_sets(spec: JoinDatasetSpec, n: int, rng: np.random.Generator):
    if spec.mean_len <= 1.0:
        lens = np.ones(n, np.int64)
    else:
        mu = np.log(spec.mean_len) - spec.len_sigma**2 / 2
        lens = np.clip(rng.lognormal(mu, spec.len_sigma, n).astype(np.int64),
                       1, min(spec.max_len, spec.universe))
    # Zipfian element popularity
    ranks = np.arange(1, spec.universe + 1, dtype=np.float64)
    probs = ranks ** (-spec.zipf_a)
    probs /= probs.sum()
    # the normalized CDF numpy's weighted choice builds on every call
    cdf = np.cumsum(probs)
    cdf /= cdf[-1]
    sets = []
    for ln in lens:
        s = (_choice_distinct(rng, probs, cdf, int(ln)) if ln < 64
             else _choice_large(rng, cdf, int(ln)))
        sets.append(np.unique(s))
    return sets


def _unique_first(idx: np.ndarray) -> np.ndarray:
    _, first = np.unique(idx, return_index=True)
    first.sort()
    return idx.take(first)


def _choice_distinct(rng, probs, cdf, size):
    """``rng.choice(len(probs), size, replace=False, p=probs)``, same
    draws from the same stream, with the first round's CDF precomputed.

    numpy's weighted draw without replacement takes ``size - found``
    uniforms per round, zeroes the probabilities found so far, rebuilds
    the normalized CDF (an O(universe) pass) and keeps the first hit of
    each new index. Most sets finish in the first round, whose CDF is
    the same for every call; later rounds rebuild it exactly as numpy
    does, so the result (and the generator's state) is unchanged."""
    found = _unique_first(cdf.searchsorted(rng.random(size), side="right"))
    if len(found) < size:
        p = probs.copy()
        while len(found) < size:
            x = rng.random(size - len(found))
            p[found] = 0
            c = np.cumsum(p)
            c /= c[-1]
            found = np.concatenate(
                [found, _unique_first(c.searchsorted(x, side="right"))])
    return found


def _choice_large(rng, cdf, ln):
    """For long sets, sample with replacement then top up — O(ln log ln).
    The weighted draw is ``rng.choice(universe, 2 * ln, p=probs)``."""
    universe = len(cdf)
    got = np.unique(cdf.searchsorted(rng.random(2 * ln), side="right"))
    if len(got) >= ln:
        return rng.permutation(got)[:ln]
    rest = np.setdiff1d(np.arange(universe), got, assume_unique=True)
    extra = rng.choice(rest, size=ln - len(got), replace=False)
    return np.concatenate([got, extra])


def make_join_dataset(name: str, scale: float = 1.0, seed: int = 0):
    """Returns disjointly-sampled (R, S) SetCollections (paper §5.1.1)."""
    spec = DATASETS[name]
    rng = np.random.default_rng(seed)
    n = max(int(spec.n_sets * scale), 1)
    r_sets = _sample_sets(spec, n, rng)
    s_sets = _sample_sets(spec, n, rng)
    R = SetCollection.from_ragged(r_sets, universe=spec.universe)
    S = SetCollection.from_ragged(s_sets, universe=spec.universe)
    return R, S


def make_skew_dataset(n: int, universe: int, a: float = 1.4, seed: int = 0,
                      max_len: int | None = None,
                      element_a: float | None = None):
    """(R, S) with Zipf(``a``)-distributed *set sizes* — the shard-skew
    stressor: a handful of huge sets next to a long tail of tiny ones,
    which is exactly the load pathology Eq. 2-3 partitioning targets.

    ``max_len`` caps the Zipf tail (default ``universe // 4``).
    ``element_a`` optionally Zipf-skews element *popularity* as well
    (ids drawn as clipped ``zipf(element_a)`` samples instead of
    uniformly), so that sets share the head elements and the LFVT grows
    deep sequences even at ``universe >> n``. The draws are the
    reference's, call for call, so a seed gives the same collections."""
    rng = np.random.default_rng(seed)
    max_len = max_len if max_len is not None else max(universe // 4, 2)

    def side():
        sizes = np.clip(rng.zipf(a, n), 1, max_len)
        if element_a is None:
            return SetCollection.from_ragged(
                [rng.choice(universe, size=int(s), replace=False)
                 for s in sizes],
                universe=universe)
        return SetCollection.from_ragged(
            [np.unique(np.minimum(rng.zipf(element_a, size=int(s)) - 1,
                                  universe - 1))
             for s in sizes],
            universe=universe)

    return side(), side()


def docs_to_sets(token_batches: np.ndarray, shingle: int = 1,
                 universe: int | None = None) -> SetCollection:
    """Token sequences (n, L) -> element sets (optionally w-shingles,
    hashed into ``8 * universe`` ids) for dedup."""
    n, L = token_batches.shape
    if shingle <= 1:
        sets = [np.unique(row) for row in token_batches]
        uni = universe or int(token_batches.max()) + 1
    else:
        base = universe or int(token_batches.max()) + 1
        sets = []
        for row in token_batches:
            acc = np.zeros(L - shingle + 1, np.int64)
            for k in range(shingle):
                acc = acc * 31 + row[k: L - shingle + 1 + k]
            sets.append(np.unique(acc % (base * 8)))
        uni = base * 8
    return SetCollection.from_ragged(sets, universe=uni)


@dataclasses.dataclass(frozen=True)
class TokenStream:
    """Deterministic-seek synthetic LM data: ``batch_at(step)`` is pure in
    (seed, step), the property the fault-tolerant loop relies on. The
    reference's numpy draw, so both packages give the same tokens; the
    int32 tensors land on ``device`` (default: the first CUDA device)."""

    vocab_size: int
    batch: int
    seq_len: int
    seed: int = 0
    device: object = None

    def batch_at(self, step: int) -> dict:
        dev = resolve_device(self.device)
        rng = np.random.default_rng((self.seed << 20) ^ step)
        toks = rng.integers(0, self.vocab_size,
                            (self.batch, self.seq_len + 1))
        toks = torch.from_numpy(toks.astype(np.int32)).to(dev)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
