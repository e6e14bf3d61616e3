"""Seeded, vectorised set generator for the benchmark's configurations.

A configuration (``configs/<name>.json``) gives a dataset's shape
(universe, mean and maximum set length, element Zipf exponent, length
sigma) and the deployment's sizes (the resident corpus S, the R
pool that the ops draw from, the share of planted near-copies). From a
seed this module makes:

* S: ``s_sets`` sets, each of a lognormal length clipped to
  ``[1, min(max_len, universe)]`` and Zipf-weighted distinct elements;
* the R pool: ``r_pool`` sets, of which ``planted_share`` are near-copies
  of S sets (``plant``) at random positions and the rest fresh draws.

The distribution is that of the repo's ``data/synth.py`` sampler (the
lognormal lengths; successive weighted sampling without replacement for
sets under 64 elements; for longer ones, 2 x length weighted draws with
replacement, a uniform subset of the distinct ones, topped up uniformly
when too few are distinct), made by whole-array passes instead of a
Python loop per set. The draws are its own, not synth's. The passes are
torch operations on the generator's device: on an H100, livej-300k (S and
the pool) takes 2-3 s with the host's share, where the same passes in
numpy took ~15 s on one core of a CPU. The same seed on the same kind of
device gives the same sets. Nothing here imports the program.

Sets come back in a flat numpy form: ``(offsets, values)``, int64 offsets
of length n + 1 and the int32 elements of each set sorted ascending.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["LARGE", "generator", "zipf_cdf", "draw_lengths",
           "weighted_distinct", "sample_sets", "copy_edits", "plant", "make",
           "split"]

#: sets of at least this many elements take synth's large-set rule
LARGE = 64
I64 = torch.int64


def generator(seed: int, device) -> torch.Generator:
    """The torch generator of ``seed`` (any whole number) on ``device``."""
    return torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)


def zipf_cdf(universe: int, a: float, device) -> torch.Tensor:
    """The normalised float64 CDF of Zipf(``a``) element popularity over
    ranks 1..universe (element id = rank - 1)."""
    p = torch.arange(1, universe + 1, dtype=torch.float64,
                     device=device) ** (-a)
    c = torch.cumsum(p / p.sum(), 0)
    return c / c[-1]


def _rand(gen: torch.Generator, n: int) -> torch.Tensor:
    return torch.rand(n, dtype=torch.float64, generator=gen,
                      device=gen.device)


def _draw(gen: torch.Generator, cdf: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` i.i.d. element ids from ``cdf``."""
    return torch.searchsorted(cdf, _rand(gen, n), right=True).clamp_(
        max=len(cdf) - 1)


def draw_lengths(gen: torch.Generator, spec: dict, n: int) -> torch.Tensor:
    """``n`` set lengths: lognormal with mean ``mean_len`` and log-sigma
    ``len_sigma``, truncated to int and clipped to [1, min(max_len, U)]."""
    if spec["mean_len"] <= 1.0:
        return torch.ones(n, dtype=I64, device=gen.device)
    sigma = spec["len_sigma"]
    mu = float(np.log(spec["mean_len"]) - sigma ** 2 / 2)
    x = torch.empty(n, dtype=torch.float64, device=gen.device)
    x.log_normal_(mu, sigma, generator=gen)
    return x.to(I64).clamp_(1, min(spec["max_len"], spec["universe"]))


def _order_by(major: torch.Tensor, minor: torch.Tensor) -> torch.Tensor:
    """The permutation sorting by (major, minor): major < 2**23 and
    minor < 2**40, both non-negative."""
    return torch.sort(major * 2 ** 40 + minor, stable=True).indices


def _first_occurrences(key: torch.Tensor) -> torch.Tensor:
    """Ascending positions of the first occurrence of each value of
    ``key``."""
    srt = torch.sort(key, stable=True)
    first = torch.ones_like(key, dtype=torch.bool)
    first[1:] = srt.values[1:] != srt.values[:-1]
    return torch.sort(srt.indices[first]).values


def _rank_in_set(sid: torch.Tensor) -> torch.Tensor:
    """0, 1, 2, ... within each run of equal ``sid`` (``sid`` grouped)."""
    if not len(sid):
        return sid.new_zeros(0)
    pos = torch.arange(len(sid), device=sid.device)
    start = torch.ones_like(sid, dtype=torch.bool)
    start[1:] = sid[1:] != sid[:-1]
    return pos - torch.cummax(torch.where(start, pos, 0), 0).values


def weighted_distinct(gen: torch.Generator, cdf: torch.Tensor,
                      want: torch.Tensor, init_sid=None, init_val=None):
    """For each set i, the first ``want[i]`` distinct values of the stream
    (its ``init`` values, then i.i.d. draws from ``cdf``).

    The first k distinct values of an i.i.d. weighted stream are a weighted
    draw of k values without replacement by successive sampling, which is
    what numpy's ``choice(replace=False, p=...)`` draws. Done in rounds:
    every set still short draws twice what it lacks, plus 8, at once.
    -> (sid, val) grouped by set, values in stream order."""
    dev = gen.device
    want = want.to(I64)
    universe = len(cdf)
    acc_sid = (torch.zeros(0, dtype=I64, device=dev) if init_sid is None
               else init_sid.to(I64))
    acc_val = (torch.zeros(0, dtype=I64, device=dev) if init_val is None
               else init_val.to(I64))
    out_sid, out_val = [], []
    active = torch.nonzero(want > 0).flatten()
    have = torch.bincount(acc_sid, minlength=len(want))
    while len(active):
        short = (want[active] - have[active]).clamp(min=0)
        k = 2 * short + 8
        sid = torch.cat([acc_sid, torch.repeat_interleave(active, k)])
        val = torch.cat([acc_val, _draw(gen, cdf, int(k.sum()))])
        # the first occurrence of each (set, value), grouped by set in
        # stream order
        keep = _first_occurrences(sid * universe + val)
        keep = keep[torch.sort(sid[keep], stable=True).indices]
        sid, val = sid[keep], val[keep]
        have = torch.bincount(sid, minlength=len(want))
        done = have >= want
        fin = done[sid] & (_rank_in_set(sid) < want[sid])
        out_sid.append(sid[fin])
        out_val.append(val[fin])
        rest = ~done[sid]
        acc_sid, acc_val = sid[rest], val[rest]
        active = torch.unique(acc_sid)
    if not out_sid:
        empty = torch.zeros(0, dtype=I64, device=dev)
        return empty, empty
    sid, val = torch.cat(out_sid), torch.cat(out_val)
    order = torch.sort(sid, stable=True).indices
    return sid[order], val[order]


def _pack(n: int, sid: torch.Tensor, val: torch.Tensor):
    """(sid, val) -> numpy (offsets, values), each set's values sorted."""
    val = val[_order_by(sid, val)]
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(torch.bincount(sid, minlength=n).cpu().numpy(),
              out=offsets[1:])
    return offsets, val.to(torch.int32).cpu().numpy()


def sample_sets(gen: torch.Generator, spec: dict, n: int):
    """``n`` sets of ``spec``'s shape -> numpy (offsets, values)."""
    dev = gen.device
    universe = spec["universe"]
    cdf = zipf_cdf(universe, spec["zipf_a"], dev)
    lens = draw_lengths(gen, spec, n)
    small = lens < LARGE
    # successive weighted sampling for the sets under LARGE
    s_sid, s_val = weighted_distinct(gen, cdf, torch.where(small, lens, 0))
    # large sets: 2 x length weighted draws with replacement ...
    big = torch.nonzero(~small).flatten()
    g_sid = torch.repeat_interleave(big, 2 * lens[big])
    g_val = _draw(gen, cdf, len(g_sid))
    keep = _first_occurrences(g_sid * universe + g_val)
    g_sid, g_val = g_sid[keep], g_val[keep]
    # ... a uniform subset of the distinct values where there are enough
    order = _order_by(g_sid, torch.randint(0, 2 ** 40, (len(g_sid),),
                                           generator=gen, device=dev))
    g_sid, g_val = g_sid[order], g_val[order]
    keep = _rank_in_set(g_sid) < lens[g_sid]
    g_sid, g_val = g_sid[keep], g_val[keep]
    # ... topped up uniformly from the elements not drawn where too few
    uniform = torch.arange(1, universe + 1, dtype=torch.float64,
                           device=dev) / universe
    t_sid, t_val = weighted_distinct(
        gen, uniform, torch.where(small, 0, lens), g_sid, g_val)
    return _pack(n, torch.cat([s_sid, t_sid]), torch.cat([s_val, t_val]))


def copy_edits(gen: torch.Generator, n: torch.Tensor,
               t: float) -> torch.Tensor:
    """How many elements each planted copy of an n-element set replaces.

    Replacing k of n elements by k the set lacks gives a copy whose
    Jaccard similarity to its source is (n - k) / (n + k). k is drawn
    uniformly from the integers within 1.5 of n (1 - t) / (1 + t), the
    real k at which the similarity is exactly t: so copies fall on both
    sides of t, and on t itself wherever n (1 - t) / (1 + t) is whole
    (for t = 0.8, n a multiple of 9: n = 36, k = 4 gives 32 / 40)."""
    k_at = n.to(torch.float64) * (1 - t) / (1 + t)
    lo = torch.ceil(k_at - 1.5 - 1e-9).clamp(min=0).to(I64)
    hi = torch.minimum(torch.floor(k_at + 1.5 + 1e-9).to(I64), n)
    return lo + (_rand(gen, len(n)) * (hi - lo + 1)).to(I64)


def plant(gen: torch.Generator, spec: dict, src_off: np.ndarray,
          src_val: np.ndarray, t: float):
    """Near-copies of the given sets: each replaces ``copy_edits`` of its
    elements, chosen uniformly, by as many Zipf-weighted elements it
    lacks -> numpy (offsets, values, k)."""
    dev = gen.device
    n_sets = len(src_off) - 1
    n = torch.from_numpy(np.diff(src_off)).to(dev)
    k = copy_edits(gen, n, t)
    sid = torch.repeat_interleave(torch.arange(n_sets, device=dev), n)
    val = torch.from_numpy(src_val.astype(np.int64)).to(dev)
    # the source's own elements open each stream, so the k new ones are
    # elements it lacks
    a_sid, a_val = weighted_distinct(
        gen, zipf_cdf(spec["universe"], spec["zipf_a"], dev), n + k, sid,
        val)
    new = _rank_in_set(a_sid) >= n[a_sid]
    # drop k of the source's elements, uniformly
    order = _order_by(sid, torch.randint(0, 2 ** 40, (len(sid),),
                                         generator=gen, device=dev))
    kept = order[_rank_in_set(sid[order]) >= k[sid[order]]]
    off, vals = _pack(n_sets, torch.cat([sid[kept], a_sid[new]]),
                      torch.cat([val[kept], a_val[new]]))
    return off, vals, k.cpu().numpy()


def make(cfg: dict, seed: int, device="cpu") -> dict:
    """A configuration's S and R pool from ``seed``, drawn on ``device``.

    -> {"s": (offsets, values), "pool": (offsets, values),
        "planted_src": (r_pool,) int64, the S row each pool row copies or
        -1, "planted_k": (r_pool,) int64, its replaced elements or -1}."""
    gen = generator(seed, device)
    t = cfg["threshold"]
    s_off, s_val = sample_sets(gen, cfg, cfg["s_sets"])
    n_pool = cfg["r_pool"]
    n_plant = int(round(cfg["planted_share"] * n_pool))
    src = torch.randperm(cfg["s_sets"], generator=gen,
                         device=gen.device)[:n_plant].cpu().numpy()
    c_off, c_val = _gather(s_off, s_val, src)
    p_off, p_val, p_k = plant(gen, cfg, c_off, c_val, t)
    f_off, f_val = sample_sets(gen, cfg, n_pool - n_plant)
    # planted rows at random positions of the pool
    pos = torch.randperm(n_pool, generator=gen,
                         device=gen.device).cpu().numpy()
    planted_at, fresh_at = pos[:n_plant], pos[n_plant:]
    lens = np.zeros(n_pool, np.int64)
    lens[planted_at] = np.diff(p_off)
    lens[fresh_at] = np.diff(f_off)
    off = np.zeros(n_pool + 1, np.int64)
    np.cumsum(lens, out=off[1:])
    vals = np.empty(int(off[-1]), np.int32)
    _scatter(vals, off, planted_at, p_off, p_val)
    _scatter(vals, off, fresh_at, f_off, f_val)
    planted_src = np.full(n_pool, -1, np.int64)
    planted_src[planted_at] = src
    planted_k = np.full(n_pool, -1, np.int64)
    planted_k[planted_at] = p_k
    return {"s": (s_off, s_val), "pool": (off, vals),
            "planted_src": planted_src, "planted_k": planted_k}


def _gather(off: np.ndarray, val: np.ndarray, rows):
    """Rows ``rows`` of a flat collection -> (offsets, values)."""
    rows = np.asarray(rows, np.int64)
    lens = off[rows + 1] - off[rows]
    out = np.zeros(len(rows) + 1, np.int64)
    np.cumsum(lens, out=out[1:])
    idx = (np.repeat(off[rows] - out[:-1], lens)
           + np.arange(int(out[-1]), dtype=np.int64))
    return out, val[idx]


def _scatter(dst, dst_off, rows, src_off, src_val) -> None:
    """Write source set j into row ``rows[j]`` of the flat ``dst``."""
    lens = np.diff(src_off)
    idx = (np.repeat(dst_off[rows] - src_off[:-1], lens)
           + np.arange(int(src_off[-1]), dtype=np.int64))
    dst[idx] = src_val


def split(offsets: np.ndarray, values: np.ndarray) -> list:
    """The flat form as a list of per-set int32 arrays (views)."""
    return np.split(values, offsets[1:-1])
