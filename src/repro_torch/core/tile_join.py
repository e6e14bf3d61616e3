"""Single-device candidate-free join driver (the LFVT methods).

The port of the JAX package's ``core/tile_join.py`` for ``method`` in
``('lfvt', 'lfvt_ref')``. S is sorted by set size descending (the FVT
"bigger nearer the root" invariant), so the Lemma-3.1 window of any
``R_i`` is a contiguous column range ``[lo_i, hi_i)`` found by binary
search. S is encoded once into a ``FlatLFVT`` whose walk arrays stay on
the device (cached per collection and device); R streams through in
blocks of ``r_block`` rows, and only the packed qualifying pairs (or, for
``emit='mask'``, the staged tile masks) come back to the host.

Blocks are double-buffered: block k+1 is dispatched before block k's
counts are synchronised. CUDA launches are asynchronous on the current
stream, so no second stream is needed for the overlap; the one
device-to-host copy of a block's per-tile counts is its only sync before
its pairs are fetched.
"""
from __future__ import annotations

import weakref

import numpy as np
import torch

from . import measures
from .config import global_config
from .device import resolve_device
from .planner import build_plan
from .resilience import (PairCapacityError, check_unmanaged, fault_point,
                         resilience_stats)
from .sets import SetCollection
from ..errors import NotPortedError

__all__ = [
    "window_bounds",
    "cf_rs_join_device",
    "round_capacity",
    "PORTED_METHODS",
]

#: the methods the port runs so far; the rest raise NotPortedError
PORTED_METHODS = ("lfvt", "lfvt_ref")


def window_bounds(r_sizes: np.ndarray, s_sizes_desc: np.ndarray, t: float,
                  measure: str = "jaccard"):
    """Column window [lo, hi) per R row over size-descending S (Lemma 3.1,
    generalized per measure — DESIGN.md §8).

    ``s_sizes_desc`` must be non-increasing. Rows outside the window can be
    skipped entirely (Theorem 3.3 / tile early stop).
    """
    asc = s_sizes_desc[::-1]
    n = len(asc)
    lo_size, hi_size = measures.get_measure(measure).size_window_arrays(
        np.asarray(r_sizes, dtype=np.int64), t)  # inclusive, integer-exact
    # first index (in desc order) with size <= hi_size:
    lo = n - np.searchsorted(asc, hi_size, side="right")
    # one past last index with size >= lo_size:
    hi = n - np.searchsorted(asc, lo_size, side="left")
    return lo.astype(np.int64), hi.astype(np.int64)


def round_capacity(n: int) -> int:
    """Regrow protocol: next power-of-two multiple of the capacity grain
    (``global_config.pair_cap_grain``) >= n, capped at
    ``global_config.pair_cap_ceiling``.

    Requests past the ceiling raise :class:`PairCapacityError`. When the
    ceiling is not itself a power-of-two multiple of the grain, in-range
    requests clamp to the ceiling instead of rounding past it.
    """
    if n <= 0:
        return 0
    ceiling = int(global_config.pair_cap_ceiling)
    if n > ceiling:
        raise PairCapacityError(
            f"pair buffer request {n} exceeds pair_cap_ceiling {ceiling} "
            f"(raise global_config.pair_cap_ceiling / REPRO_PAIR_CAP_CEILING"
            f" or reduce the block size)")
    cap = global_config.pair_cap_grain
    while cap < n:
        cap *= 2
    return min(cap, ceiling)


# ------------------------------------------------------------------ #
# device-resident S representation cache: the size-sorted collection and
# its FlatLFVT (whose walk arrays are uploaded once per device) live as
# long as the source collection. WeakKeyDictionary -> entries die with
# the collection (collections are immutable by convention).
# ------------------------------------------------------------------ #
_S_REP_CACHE: "weakref.WeakKeyDictionary[SetCollection, dict]" = (
    weakref.WeakKeyDictionary())


def _s_device_rep(S: SetCollection, device: torch.device,
                  stats: dict | None = None):
    """-> (sorted collection, FlatLFVT uploaded to ``device``, np sizes)."""
    fault_point("device_upload")
    entry = _S_REP_CACHE.get(S)
    if entry is None:
        entry = {}
        _S_REP_CACHE[S] = entry
    key = ("lfvt", str(device))
    hit = "sorted" in entry and key in entry
    if "sorted" not in entry:
        # None = "the key itself is already sorted": the cache value must
        # not hold a strong reference to its own WeakKeyDictionary key
        Ss = None if S.sorted_by_size else S.sort_by_size()
        entry["sorted"] = Ss
        entry["sizes_np"] = (S if Ss is None else Ss).sizes()
    Ss = entry["sorted"] if entry["sorted"] is not None else S
    if key not in entry:
        flat = Ss.flat_lfvt()    # memoized on the collection
        flat.to_device(device)   # one upload per device, cached on it
        entry[key] = flat
    if stats is not None:
        stats["s_rep_cache_hit"] = hit
    return Ss, entry[key], entry["sizes_np"]


# ------------------------------------------------------------------ #
# device-resident R-block cache: (device, block range) -> the uploaded
# (mb, Lr) -1-padded element lists, per source collection (weakly)
# ------------------------------------------------------------------ #
_R_BLOCK_CACHE: "weakref.WeakKeyDictionary[SetCollection, dict]" = (
    weakref.WeakKeyDictionary())
# bound on cached block uploads per collection (LRU)
_R_BLOCK_CACHE_MAX_ENTRIES = 64


def _r_block_rep(R: SetCollection, device: torch.device, start: int,
                 stop: int):
    """-> (device rep of R[start:stop], cache_hit)."""
    fault_point("device_upload")
    entry = _R_BLOCK_CACHE.get(R)
    if entry is None:
        entry = {}
        _R_BLOCK_CACHE[R] = entry
    key = ("padded", str(device), start, stop)
    hit = key in entry
    if hit:
        entry[key] = entry.pop(key)  # LRU: move to the fresh end
    else:
        if len(entry) >= _R_BLOCK_CACHE_MAX_ENTRIES:
            entry.pop(next(iter(entry)))  # evict least-recently used
        host = R.padded()[0][start:stop]
        entry[key] = torch.tensor(host, dtype=torch.int32, device=device)
    return entry[key], hit


def cf_rs_join_device(R: SetCollection, S: SetCollection, t: float,
                      method: str = "lfvt", r_block: int | None = None,
                      stats: dict | None = None, emit: str = "pairs",
                      pair_capacity: int | None = None,
                      double_buffer: bool | None = None,
                      measure: str = "jaccard",
                      fault_plan=None,
                      checkpoint_dir: str | None = None,
                      plan=None, device=None) -> set:
    """Candidate-free device join. Returns {(r_id, s_id)}.

    method: 'lfvt' — the live row-tiled walk (the CUDA kernel on a GPU,
            its plain PyTorch version on the CPU) with walk_steps /
            early_stops / live_tiles stats; 'lfvt_ref' — the whole-block
            walk; 'auto' — the cost-model planner, which raises
            ``NotPortedError`` when it picks a family the port does not
            have yet. The default is 'lfvt' (the JAX driver's legacy
            default, 'popcount', is not ported).
    emit:   'pairs' (default) — qualifying pairs are compacted on the
            device and only the packed array comes back; 'mask' — the
            staged tile masks come back and are scanned on the host.
    pair_capacity: optional initial pair-buffer capacity per R block for
            emit='pairs'; regrown on overflow.
    double_buffer: dispatch block k+1 before block k's count sync.
            Results are identical with it off.
    device: 'cuda' (the default) or 'cpu'; see ``resolve_device``.

    ``fault_plan``/``checkpoint_dir`` (the resilience ladder) raise
    ``NotPortedError``. ``r_block`` and ``double_buffer`` default to
    ``global_config`` when None.
    """
    device = resolve_device(device)
    if plan is None:
        plan = build_plan(R, S, t, method=method, measure=measure,
                          emit=emit, r_block=r_block,
                          pair_capacity=pair_capacity,
                          double_buffer=double_buffer)
    method = plan.method
    r_block = plan.r_block or global_config.r_block
    double_buffer = plan.double_buffer
    R.validate()
    S.validate()
    check_unmanaged(fault_plan if fault_plan is not None
                    else (global_config.fault or None), checkpoint_dir)
    if not len(R) or not len(S):
        if stats is not None:  # consumers index these unconditionally
            stats.update(method=method, emit=emit, r_blocks=0, pair_count=0,
                         output_bytes=0, dense_mask_bytes=0,
                         double_buffered=double_buffer, regrows=0,
                         r_rep_cache_hits=0, plan=plan.to_dict(),
                         device=str(device))
            resilience_stats(stats)
        return set()
    if method not in PORTED_METHODS:
        raise NotPortedError(
            f"method {method!r} ({plan.decided} pick for "
            f"method={plan.requested!r}) is not ported to PyTorch yet; the "
            f"port runs {PORTED_METHODS}")
    from ..kernels import ops as kops  # deferred: kernels import this

    Ss, flat, s_sizes = _s_device_rep(S, device, stats)
    r_sizes_all = R.sizes()
    # int32 exactness guard for the device predicate (DESIGN.md §8)
    measures.get_measure(measure).validate(
        t, max(int(r_sizes_all.max(initial=0)), int(s_sizes.max(initial=0))))
    lo_all, hi_all = window_bounds(r_sizes_all, s_sizes, t, measure)
    universe = max(R.universe, S.universe)
    W = max((universe + 31) // 32, 1)

    pairs: set = set()
    m = len(R)
    acc = {"out_sparse": 0, "out_dense": 0, "n_pairs": 0, "live": 0,
           "total_tiles": 0, "regrows": 0, "r_rep_hits": 0,
           "walk_steps": 0, "early_stops": 0, "walk_vmem": 0}

    def fold_kernel_stats(kstats: dict) -> None:
        acc["live"] += kstats.get("live_tiles", 0)
        acc["total_tiles"] += kstats.get("total_tiles", 0)
        acc["walk_steps"] += kstats.get("walk_steps", 0)
        acc["early_stops"] += kstats.get("early_stops", 0)
        acc["walk_vmem"] = max(acc["walk_vmem"],
                               kstats.get("walk_vmem_tile_bytes", 0))

    def dispatch(start: int, stop: int) -> dict:
        """Launch all of one R block's device work; no host syncs."""
        sl = slice(start, stop)
        r_rep, hit = _r_block_rep(R, device, start, stop)
        acc["r_rep_hits"] += hit
        acc["out_dense"] += (stop - start) * len(Ss)
        if method == "lfvt":
            # live row-tiled walk; host np row metadata so the dispatch
            # plans tiles without syncing device arrays
            pending = kops.lfvt_walk_join_pairs_dispatch(
                flat, r_rep, r_sizes_all[sl], lo_all[sl], hi_all[sl], t,
                measure=measure, row_tile=plan.row_tile)
        else:  # lfvt_ref: whole-block walk as one live tile
            pending = kops.lfvt_join_pairs_dispatch(
                flat, r_rep, r_sizes_all[sl], lo_all[sl], hi_all[sl], t,
                measure=measure)
        return {"start": start, "mb": stop - start, "pending": pending}

    def finalize(blk: dict) -> None:
        """Sync one block's counts, compact (regrowing if needed) and fold
        its pairs into the result set."""
        start = blk["start"]
        fault_point("compact")
        kstats: dict = {}
        if emit == "pairs":
            pp, n_pairs = kops.join_pairs_finalize(
                blk["pending"], capacity=pair_capacity, stats=kstats)
            local = pp[:n_pairs].cpu().numpy() if n_pairs else (
                np.zeros((0, 2), np.int64))
            acc["out_sparse"] += 8 * n_pairs + 4 + kstats.get(
                "counts_bytes", 0)
            acc["regrows"] += kstats.get("regrows", 0)
        else:
            mask_np = kops.join_mask_finalize(blk["pending"], blk["mb"],
                                              len(Ss), kstats)
            acc["out_sparse"] += mask_np.size
            rr, ss = np.nonzero(mask_np)
            local = np.stack([rr, ss], axis=1) if len(rr) else (
                np.zeros((0, 2), np.int64))
            n_pairs = len(local)
        fold_kernel_stats(kstats)
        if len(local):
            rid = R.ids[start + local[:, 0]]
            sid = Ss.ids[local[:, 1]]
            pairs.update(zip(map(int, rid), map(int, sid)))
        acc["n_pairs"] += n_pairs

    in_flight: dict | None = None
    for start in range(0, m, r_block):
        # block k+1 launches before block k syncs
        blk = dispatch(start, min(start + r_block, m))
        if in_flight is not None:
            finalize(in_flight)
        if double_buffer:
            in_flight = blk
        else:
            finalize(blk)
    if in_flight is not None:
        finalize(in_flight)

    if stats is not None:
        stats["method"] = method
        stats["measure"] = measure
        stats["emit"] = emit
        stats["plan"] = plan.to_dict()
        stats["device"] = str(device)
        stats["r_blocks"] = -(-m // r_block)
        stats["pair_count"] = acc["n_pairs"]
        stats["output_bytes"] = acc["out_sparse"]
        stats["dense_mask_bytes"] = acc["out_dense"]
        stats["double_buffered"] = double_buffer
        stats["regrows"] = acc["regrows"]
        stats["r_rep_cache_hits"] = acc["r_rep_hits"]
        stats["live_tiles"] = acc["live"]
        stats["total_tiles"] = acc["total_tiles"]
        if method == "lfvt":
            stats["walk_steps"] = acc["walk_steps"]
            stats["early_stops"] = acc["early_stops"]
            stats["walk_vmem_tile_bytes"] = acc["walk_vmem"]
        # the §9 memory axis: what the flat S rep holds on the device vs
        # what the bitmap sheet would have cost at this universe
        stats["s_flat_bytes"] = flat.nbytes()
        stats["s_flat_seq_bytes"] = int(flat.seq_row.nbytes)
        stats["s_bitmap_bytes_equiv"] = len(Ss) * W * 4
        resilience_stats(stats)
    return pairs
