"""Single-device candidate-free join driver (every single-device method).

The port of the JAX package's ``core/tile_join.py``. S is sorted by set
size descending (the FVT "bigger nearer the root" invariant), so the
Lemma-3.1 window of any ``R_i`` is a contiguous column range
``[lo_i, hi_i)`` found by binary search. S is staged on the device once
per collection (the ``FlatLFVT`` walk arrays for the LFVT methods, the
``(n, W)`` membership bitmaps for the popcount and one-hot methods); R
streams through in blocks of ``r_block`` rows, and only the packed
qualifying pairs (or, for ``emit='mask'``, the block masks) come back to
the host.

This module also holds the plain PyTorch counting and qualify primitives
(``popcount_counts``, ``qualify``, ``_popcount_qualify``) behind the
popcount kernels, and the dense-mask compaction (``_mask_total``,
``_compact_mask``).

Blocks are double-buffered: block k+1 is dispatched before block k's
counts are synchronised. CUDA launches are asynchronous on the current
stream, so no second stream is needed for the overlap; the one
device-to-host copy of a block's pair count is its only sync before its
pairs are fetched. With ``fault_plan=``/``checkpoint_dir=`` (or
``REPRO_FAULT``) each R block is instead a task of the resilience ladder
(``core/resilience.py``), run synchronously: the method, then the host
oracle.
"""
from __future__ import annotations

import functools
import weakref

import numpy as np
import torch

from .. import trace
from . import measures
from .config import global_config, resolve_guardrail_budget
from .device import resolve_device
from .planner import build_plan
from .resilience import (PairCapacityError, build_resilience, checked_flat,
                         collection_digest, fault_point, resilience_stats,
                         sorted_pairs)
from .sets import EmptyCollectionError, SetCollection

__all__ = [
    "popcount_row_block",
    "popcount_counts",
    "onehot_counts",
    "qualify",
    "window_bounds",
    "cf_rs_join_device",
    "cf_rs_join_device_ids",
    "clear_s_rep_cache",
    "clear_r_block_cache",
    "round_capacity",
    "PAIR_CAP_GRAIN",
]

#: byte budget of a plain version's staged intermediate (the popcount's
#: (rows, cols, words) int64 AND, the one-hot product's unpacked float32
#: chunk), per device type: a few MB on the CPU, where larger stages run
#: slower; on a GPU large enough that launches do not dominate, and never
#: more than a few GB with the temporaries
STAGE_BYTES = {"cpu": 1 << 22, "cuda": 1 << 30}


def stage_budget(device: torch.device) -> int:
    """``STAGE_BYTES`` for ``device``'s type (256 MiB for another type)."""
    return STAGE_BYTES.get(device.type, 1 << 28)


# ---------------------------------------------------------------------- #
# device-side primitives (plain torch; the popcount kernels mirror these)
# ---------------------------------------------------------------------- #
def popcount_row_block(m: int, n: int) -> int:
    """R-row block size bounding ``popcount_counts``' (mb, n, W) staged
    intermediate (the reference's rule; ``popcount_counts`` also caps the
    block by ``stage_budget``)."""
    return max(1, min(m, 4096 // max(1, n // 1024 + 1)))


def _words64(bitmaps: torch.Tensor) -> torch.Tensor:
    """(rows, W) int32 words -> (rows, ceil(W/2)) int64 holding the same
    bits, two words per lane (a zero word pads an odd W). Popcounts of
    ANDs do not depend on how the words are paired."""
    x = bitmaps.to(torch.int32)
    if x.shape[1] % 2:
        x = torch.cat([x, x.new_zeros((x.shape[0], 1))], dim=1)
    return x.contiguous().view(torch.int64)


def _popcount_sum(x: torch.Tensor) -> torch.Tensor:
    """SWAR bit count of the int64 lanes of ``x`` (..., w), summed over
    the last axis -> (...) int32. ``x`` is scratch: it is overwritten.

    Bit 63 is counted apart (as ``x < 0``), so the shifts and adds run on
    non-negative values, where an arithmetic right shift is a logical one
    and nothing overflows. The per-byte counts are summed over groups of
    ``g <= 18`` lanes (the largest divisor of ``w`` up to 18) before the
    bytes of each group are folded: a byte then holds at most 8 * 18 =
    144 and the top byte (bit 63 cleared) at most 7 * 18 = 126, so no
    byte carries into the next and no sum leaves the non-negative int64s.
    """
    neg = (x < 0).sum(-1, dtype=torch.int32)
    x &= 0x7FFFFFFFFFFFFFFF
    y = x >> 1
    y &= 0x5555555555555555
    x -= y
    y = x >> 2
    y &= 0x3333333333333333
    x &= 0x3333333333333333
    x += y
    x += x >> 4
    x &= 0x0F0F0F0F0F0F0F0F
    w = x.shape[-1]
    g = max(d for d in range(1, 19) if w % d == 0) if w else 1
    b = x.unflatten(-1, (w // g, g)).sum(-1)
    b = (b & 0x00FF00FF00FF00FF) + ((b >> 8) & 0x00FF00FF00FF00FF)
    b += b >> 16
    b += b >> 32
    return neg + (b & 0xFFFF).sum(-1, dtype=torch.int32)


def popcount_counts(r_bitmaps: torch.Tensor,
                    s_bitmaps: torch.Tensor) -> torch.Tensor:
    """(m, W) x (n, W) int32-held uint32 words -> (m, n) int32
    intersection sizes.

    Blocked over R rows (``popcount_row_block``) and S rows so that the
    staged (mb, nb, W/2) int64 AND never exceeds the device's
    ``stage_budget``."""
    r, s = _words64(r_bitmaps), _words64(s_bitmaps)
    m, n, w = r.shape[0], s.shape[0], r.shape[1]
    out = torch.empty((m, n), dtype=torch.int32, device=r.device)
    if not m or not n:
        return out
    cells = max(1, stage_budget(r.device) // (8 * max(w, 1)))
    nb = min(n, cells)
    mb = max(1, min(popcount_row_block(m, n), cells // nb))
    for a in range(0, m, mb):
        for b in range(0, n, nb):
            out[a:a + mb, b:b + nb] = _popcount_sum(
                r[a:a + mb, None, :] & s[None, b:b + nb, :])
    return out


def onehot_counts(r_padded: torch.Tensor, r_sizes: torch.Tensor,
                  s_padded: torch.Tensor, s_sizes: torch.Tensor,
                  universe: int, block: int = 512) -> torch.Tensor:
    """Intersection sizes of -1-padded element lists via blocked one-hot
    products -> (m, n) int32, on the operands' device.

    Streams the universe in ``block``-wide chunks, as the reference does:
    membership matrices ``B_R (m, block)``, ``B_S (n, block)`` and
    ``F += B_R @ B_S^T`` in float32 (exact: a count never passes 2**24).
    No driver path calls it: the ``onehot`` methods count over bitmaps
    (K5, ``onehot_join``)."""
    m, n = r_padded.shape[0], s_padded.shape[0]
    out = torch.zeros((m, n), dtype=torch.float32, device=r_padded.device)
    for start in range(0, universe, block):
        br = _membership_block(r_padded, start, block)
        bs = _membership_block(s_padded, start, block)
        out += br @ bs.T
    return out.to(torch.int32)


def _membership_block(padded: torch.Tensor, start: int,
                      block: int) -> torch.Tensor:
    """One-hot membership of elements in [start, start + block) ->
    (rows, block) float32 (a -1 pad is no member), built in row groups
    whose staged one-hot stays within ``stage_budget``."""
    rows, lanes = padded.shape
    out = torch.zeros((rows, block), dtype=torch.float32,
                      device=padded.device)
    # rows per group: the staged (rows, lanes, block) int64 one-hot
    step = max(1, stage_budget(padded.device)
               // (8 * block * max(lanes, 1)))
    for a in range(0, rows, step):
        rel = padded[a:a + step].to(torch.int64) - start
        valid = (rel >= 0) & (rel < block) & (padded[a:a + step] >= 0)
        onehot = torch.nn.functional.one_hot(
            torch.where(valid, rel, 0), block).to(torch.float32)
        out[a:a + step] = (onehot * valid[..., None]).sum(1)
    return out


def qualify(counts: torch.Tensor, r_sizes: torch.Tensor,
            s_sizes: torch.Tensor, t: float,
            measure: str = "jaccard") -> torch.Tensor:
    """``sim >= t`` as a boolean tile via the integer-exact
    cross-multiplied predicate (DESIGN.md §8); f > 0 required. Sizes are
    1-D: ``r_sizes`` (m,), ``s_sizes`` (n,)."""
    return measures.device_qualify(counts, r_sizes[:, None],
                                   s_sizes[None, :], t, measure)


def _popcount_qualify(r_bm, r_sz, s_bm, s_sz, col_lo, col_hi, *, t,
                      measure="jaccard") -> torch.Tensor:
    """Popcount counts, the measure predicate and the [lo, hi) window ->
    (m, n) bool: the popcount join of m R rows against n S columns."""
    counts = popcount_counts(r_bm, s_bm)
    cols = torch.arange(s_bm.shape[0], device=counts.device)[None, :]
    in_window = (cols >= col_lo[:, None]) & (cols < col_hi[:, None])
    return qualify(counts, r_sz, s_sz, t, measure) & in_window


def _onehot_qualify(r_pad, r_sz, s_pad, s_sz, col_lo, col_hi, *, t,
                    universe, measure="jaccard") -> torch.Tensor:
    """``onehot_counts`` over the padded element lists, the predicate and
    the [lo, hi) window -> (m, n) bool."""
    counts = onehot_counts(r_pad, r_sz, s_pad, s_sz, universe)
    cols = torch.arange(s_pad.shape[0], device=counts.device)[None, :]
    in_window = (cols >= col_lo[:, None]) & (cols < col_hi[:, None])
    return qualify(counts, r_sz, s_sz, t, measure) & in_window


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


#: the capacity grain at import (``global_config.pair_cap_grain`` is the
#: live value ``round_capacity`` reads); the kernels layer re-exports it
PAIR_CAP_GRAIN = global_config.pair_cap_grain


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


def _mask_total(mask: torch.Tensor) -> torch.Tensor:
    """Device-side pair count of a dense bool mask (0-d int32)."""
    return mask.sum(dtype=torch.int32)


def _compact_mask(mask: torch.Tensor, *, size: int) -> torch.Tensor:
    """Device-side segment compaction of a dense bool mask.

    An (m, n) mask packs to (size, 2) (row, col) int32, row-major;
    entries past the true count are -1: the capacity padding of the
    reference's ``jnp.nonzero(size=, fill_value=-1)``, kept so that
    ``pair_bytes = size * 8`` means the same buffer.
    """
    return torch.nonzero_static(mask, size=size, fill_value=-1).to(
        torch.int32)


# ------------------------------------------------------------------ #
# device-resident S representation cache: the size-sorted collection and
# its device reps (the FlatLFVT, whose walk arrays are uploaded once per
# device, or the (n, W) bitmap sheet and its compressed nonzero words)
# live as long as the source collection. WeakKeyDictionary -> entries die
# with the collection (collections are immutable by convention).
# ------------------------------------------------------------------ #
_S_REP_CACHE: "weakref.WeakKeyDictionary[SetCollection, dict]" = (
    weakref.WeakKeyDictionary())


def clear_s_rep_cache() -> None:
    """Drop every cached S rep on every device, the uploads that cached
    ``FlatLFVT`` tables hold included: the next join stages S again."""
    for entry in list(_S_REP_CACHE.values()):
        for key, rep in entry.items():
            if isinstance(key, tuple) and key[0] == "lfvt":
                rep.drop_uploads()
    _S_REP_CACHE.clear()


def _s_device_rep(S: SetCollection, family: str, W: int,
                  device: torch.device, stats: dict | None = None):
    """-> (sorted collection, device rep, device sizes, np sizes).

    family 'bitmap' -> the bitmap sheet as an int32 tensor with the
    uint32 bits, padded once as the tiled kernels' launches pad it
    (``ops.pad_sheet``: rows past n are zero); 'sparse' -> that sheet's
    nonzero words as K2/K3 read them (``bitmap_join.compress_s``),
    cached beside it; 'lfvt' -> the ``FlatLFVT`` uploaded to ``device``.
    """
    fault_point("device_upload")
    entry = _S_REP_CACHE.get(S)
    if entry is None:
        entry = {}
        _S_REP_CACHE[S] = entry
    dev = str(device)
    key = ("lfvt", dev) if family == "lfvt" else (family, W, dev)
    hit = "sorted" in entry and key in entry
    if not hit:
        with trace.span("stage_s"):
            _stage_s(S, entry, family, key, W, device)
    if stats is not None:
        stats["s_rep_cache_hit"] = hit
    Ss = entry["sorted"] if entry["sorted"] is not None else S
    return Ss, entry[key], entry[("sizes", dev)], entry["sizes_np"]


def _stage_s(S: SetCollection, entry: dict, family: str, key: tuple, W: int,
             device: torch.device) -> None:
    """Build what ``_s_device_rep``'s ``entry`` lacks for ``key``."""
    from ..kernels import bitmap_join, ops  # deferred: kernels import this
    dev = str(device)
    if "sorted" not in entry:
        # None = "the key itself is already sorted": the cache value must
        # not hold a strong reference to its own WeakKeyDictionary key
        with trace.span("stage_s.sort"):
            Ss = None if S.sorted_by_size else S.sort_by_size()
            entry["sorted"] = Ss
            entry["sizes_np"] = (S if Ss is None else Ss).sizes()
    Ss = entry["sorted"] if entry["sorted"] is not None else S
    if ("sizes", dev) not in entry:
        with trace.span("stage_s.upload"):
            entry[("sizes", dev)] = torch.tensor(
                entry["sizes_np"], dtype=torch.int32, device=device)
        trace.count("stage_s.upload_bytes", entry[("sizes", dev)].nbytes)
    sheet = ("bitmap", W, dev)
    if family != "lfvt" and sheet not in entry:
        host = Ss.bitmaps(W).view(np.int32)
        with trace.span("stage_s.upload"):
            words = torch.tensor(host, device=device)
        trace.count("stage_s.upload_bytes", words.nbytes)
        with trace.span("stage_s.pad_sheet"):
            entry[sheet] = ops.pad_sheet(words)
    if key not in entry:
        if family == "sparse":
            with trace.span("stage_s.compress_s"):
                entry[key] = bitmap_join.compress_s(entry[sheet])
        else:
            flat = Ss.flat_lfvt()    # memoized on the collection
            with trace.span("stage_s.upload"):
                # one upload per device, cached on it
                up = flat.to_device(device)
            trace.count("stage_s.upload_bytes", sum(a.nbytes for a in up))
            entry[key] = flat


# ------------------------------------------------------------------ #
# device-resident R-block cache: (family, device, block range) -> the
# uploaded block rep (the (mb, Lr) -1-padded element lists, or the
# (mb, W) bitmaps), per source collection (weakly)
# ------------------------------------------------------------------ #
_R_BLOCK_CACHE: "weakref.WeakKeyDictionary[SetCollection, dict]" = (
    weakref.WeakKeyDictionary())
# bound on cached block uploads per collection (LRU)
_R_BLOCK_CACHE_MAX_ENTRIES = 64


def clear_r_block_cache() -> None:
    """Drop every cached R-block upload on every device."""
    _R_BLOCK_CACHE.clear()


def _r_block_rep(R: SetCollection, family: str, W: int,
                 device: torch.device, start: int, stop: int):
    """-> (device rep of R[start:stop], cache_hit)."""
    fault_point("device_upload")
    entry = _R_BLOCK_CACHE.get(R)
    if entry is None:
        entry = {}
        _R_BLOCK_CACHE[R] = entry
    key = (("bitmap", W, str(device), start, stop) if family == "bitmap"
           else ("padded", str(device), start, stop))
    hit = key in entry
    if hit:
        entry[key] = entry.pop(key)  # LRU: move to the fresh end
    else:
        if len(entry) >= _R_BLOCK_CACHE_MAX_ENTRIES:
            entry.pop(next(iter(entry)))  # evict least-recently used
        with trace.span("block.upload"):
            host = (R.bitmaps(W).view(np.int32) if family == "bitmap"
                    else R.padded()[0])
            entry[key] = torch.tensor(host[start:stop], dtype=torch.int32,
                                      device=device)
        trace.count("block.upload_bytes", entry[key].nbytes)
    return entry[key], hit


def cf_rs_join_device(R: SetCollection, S: SetCollection, t: float,
                      method: str = "popcount", r_block: int | None = None,
                      stats: dict | None = None, emit: str = "pairs",
                      pair_capacity: int | None = None,
                      double_buffer: bool | None = None,
                      measure: str = "jaccard",
                      fault_plan=None,
                      checkpoint_dir: str | None = None,
                      plan=None, device=None) -> set:
    """Candidate-free device join. Returns {(r_id, s_id)}.

    method: 'popcount' (the default, as in the JAX driver) — bitmap
            AND-popcount over the dense block, gated by the tile skip
            mask (kernel K3 on a GPU); 'onehot' — the membership product
            over the same bitmaps (kernel K5); 'kernel_bitmap' /
            'kernel_onehot' — with emit='pairs' the live-tile schedule
            (kernels K2 / K4: skipped tiles cost nothing, per-tile counts
            size the pair buffer), with emit='mask' K3 / K5; 'lfvt' — the
            live row-tiled walk (kernel K1) with walk_steps / early_stops
            / live_tiles stats; 'lfvt_ref' — the whole-block walk;
            'auto' — the cost-model planner's pick. Every kernel runs on
            a GPU; on the CPU its plain PyTorch version runs instead.
    emit:   'pairs' (default) — qualifying pairs are compacted on the
            device and only the packed array comes back; 'mask' — the
            block masks come back and are scanned on the host.
    pair_capacity: optional initial pair-buffer capacity per R block for
            emit='pairs'; regrown on overflow.
    double_buffer: dispatch block k+1 before block k's count sync.
            Results are identical with it off.
    device: 'cuda' (the default) or 'cpu'; see ``resolve_device``.

    fault_plan / checkpoint_dir activate the resilience layer
    (core/resilience.py, DESIGN.md §12): per-R-block tasks run under the
    retry + degradation ladder (method -> host oracle), with optional
    per-block checkpoints for resume. None/None (and an empty
    ``REPRO_FAULT``) keeps the streaming path.

    ``r_block`` and ``double_buffer`` default to ``global_config`` when
    None.
    """
    with trace.span("driver"):
        r_ids, s_ids = cf_rs_join_device_ids(
            R, S, t, method=method, r_block=r_block, stats=stats, emit=emit,
            pair_capacity=pair_capacity, double_buffer=double_buffer,
            measure=measure, fault_plan=fault_plan,
            checkpoint_dir=checkpoint_dir, plan=plan, device=device)
        return set(zip(r_ids.tolist(), s_ids.tolist()))


def cf_rs_join_device_ids(R: SetCollection, S: SetCollection, t: float,
                          method: str = "popcount",
                          r_block: int | None = None,
                          stats: dict | None = None, emit: str = "pairs",
                          pair_capacity: int | None = None,
                          double_buffer: bool | None = None,
                          measure: str = "jaccard",
                          fault_plan=None,
                          checkpoint_dir: str | None = None,
                          plan=None, device=None):
    """``cf_rs_join_device`` with the pairs as two int64 arrays ``(r_ids,
    s_ids)``, one entry per pair in block order, and no Python set: for
    callers that handle millions of pairs. Same arguments and stats.
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
    if global_config.strict_validation and (not len(R) or not len(S)):
        side = "R" if not len(R) else "S"
        raise EmptyCollectionError(
            f"empty {side} collection (strict_validation is on)")
    res = build_resilience(checkpoint_dir, fault_plan)
    if not len(R) or not len(S):
        if stats is not None:  # consumers index these unconditionally
            stats.update(method=method, emit=emit, r_blocks=0, pair_count=0,
                         output_bytes=0, dense_mask_bytes=0,
                         double_buffered=double_buffer, regrows=0,
                         r_rep_cache_hits=0, plan=plan.to_dict(),
                         device=str(device))
            resilience_stats(stats, res)
        return np.empty(0, np.int64), np.empty(0, np.int64)
    from ..kernels import ops as kops  # deferred: kernels import this

    family = "lfvt" if method in ("lfvt", "lfvt_ref") else "bitmap"
    universe = max(R.universe, S.universe)
    W = max((universe + 31) // 32, 1)
    Ss, s_rep, s_sz, s_sizes = _s_device_rep(S, family, W, device, stats)
    # K2/K3 read S through its compressed nonzero words; their plain
    # versions (the CPU path) never do
    popcount = method in ("popcount", "kernel_bitmap")
    s_sparse = (_s_device_rep(S, "sparse", W, device)[1]
                if popcount and device.type == "cuda" else None)
    with trace.span("bounds"):
        r_sizes_all = R.sizes()
        # int32 exactness guard for the device predicate (DESIGN.md §8)
        measures.get_measure(measure).validate(
            t, max(int(r_sizes_all.max(initial=0)),
                   int(s_sizes.max(initial=0))))
        lo_all, hi_all = window_bounds(r_sizes_all, s_sizes, t, measure)

    kernel_pairs = (emit == "pairs" and method in (
        "kernel_bitmap", "kernel_onehot", "lfvt", "lfvt_ref"))
    # the dense path's speculative per-block compaction capacity: fixed
    # (never carried between blocks) so the byte accounting stays
    # deterministic
    spec_cap = round_capacity(pair_capacity) if pair_capacity else (
        global_config.pair_cap_grain)

    r_out: list = []
    s_out: list = []
    m = len(R)

    def zero_acc() -> dict:
        return {"out_sparse": 0, "out_dense": 0, "n_pairs": 0, "live": 0,
                "total_tiles": 0, "regrows": 0, "r_rep_hits": 0,
                "walk_steps": 0, "early_stops": 0, "walk_vmem": 0}

    acc = zero_acc()

    def fold_kernel_stats(acc: dict, kstats: dict) -> None:
        acc["live"] += kstats.get("live_tiles", 0)
        acc["total_tiles"] += kstats.get("total_tiles", 0)
        acc["walk_steps"] += kstats.get("walk_steps", 0)
        acc["early_stops"] += kstats.get("early_stops", 0)
        acc["walk_vmem"] = max(acc["walk_vmem"],
                               kstats.get("walk_vmem_tile_bytes", 0))

    def dispatch(start: int, stop: int, acc: dict) -> dict:
        """Launch all of one R block's device work; no host syncs."""
        with trace.span("block.dispatch"):
            sl = slice(start, stop)
            r_rep, hit = _r_block_rep(R, family, W, device, start, stop)
            acc["r_rep_hits"] += hit
            acc["out_dense"] += (stop - start) * len(Ss)
            blk: dict = {"start": start, "mb": stop - start}
            if method == "lfvt":
                # live row-tiled walk; host np row metadata so the dispatch
                # plans tiles without syncing device arrays
                blk["pending"] = kops.lfvt_walk_join_pairs_dispatch(
                    s_rep, r_rep, r_sizes_all[sl], lo_all[sl], hi_all[sl], t,
                    measure=measure, row_tile=plan.row_tile)
            elif method == "lfvt_ref":  # whole-block walk as one live tile
                blk["pending"] = kops.lfvt_join_pairs_dispatch(
                    s_rep, r_rep, r_sizes_all[sl], lo_all[sl], hi_all[sl], t,
                    measure=measure)
            elif kernel_pairs:
                # live-tile schedule + in-kernel counts; count sync deferred
                if method == "kernel_bitmap":
                    blk["pending"] = kops.bitmap_join_pairs_dispatch(
                        r_rep, r_sizes_all[sl], s_rep, s_sz, lo_all[sl],
                        hi_all[sl], t, measure=measure, s_sparse=s_sparse)
                else:
                    blk["pending"] = kops.onehot_join_pairs_dispatch(
                        r_rep, r_sizes_all[sl], s_rep, s_sz, lo_all[sl],
                        hi_all[sl], t, measure=measure)
            else:
                if popcount:
                    mask = kops.bitmap_join(
                        r_rep, r_sizes_all[sl], s_rep, s_sz, lo_all[sl],
                        hi_all[sl], t, measure=measure, s_sparse=s_sparse)
                else:
                    mask = kops.onehot_join(
                        r_rep, r_sizes_all[sl], s_rep, s_sz, lo_all[sl],
                        hi_all[sl], t, measure=measure)
                blk["mask"] = mask
                if emit == "pairs":
                    # speculative on-device compaction at the fixed capacity;
                    # the exact count rides along and syncs only at finalize
                    blk["total"] = _mask_total(mask)
                    with trace.span("block.compact"):
                        blk["packed"] = _compact_mask(mask, size=spec_cap)
            return blk

    def finalize(blk: dict, acc: dict, r_out: list, s_out: list) -> None:
        """Sync one block's counts, compact (regrowing if needed) and fold
        its pairs into ``r_out``/``s_out``."""
        with trace.span("block.finalize"):
            start = blk["start"]
            fault_point("compact")
            if "pending" in blk:
                kstats: dict = {}
                if emit == "pairs":
                    pp, n_pairs = kops.join_pairs_finalize(
                        blk["pending"], capacity=pair_capacity, stats=kstats)
                    with trace.span("block.fetch"):
                        local = pp[:n_pairs].cpu().numpy()
                    acc["out_sparse"] += 8 * n_pairs + 4 + kstats.get(
                        "counts_bytes", 0)
                    acc["regrows"] += kstats.get("regrows", 0)
                else:
                    mask_np = kops.join_mask_finalize(
                        blk["pending"], blk["mb"], len(Ss), kstats)
                fold_kernel_stats(acc, kstats)
            elif emit == "pairs":
                with trace.span("block.sync"):
                    # the only host sync per block
                    n_pairs = int(blk["total"])
                cap = spec_cap
                # overflow: regrow exactly once (count known)
                if cap < n_pairs:
                    fault_point("regrow")
                    cap = round_capacity(n_pairs)
                    with trace.span("block.compact"):
                        blk["packed"] = _compact_mask(blk["mask"], size=cap)
                    acc["regrows"] += 1
                with trace.span("block.fetch"):
                    local = blk["packed"][:n_pairs].cpu().numpy()
                acc["out_sparse"] += 8 * n_pairs + 4
            else:
                with trace.span("block.fetch"):
                    mask_np = blk["mask"].cpu().numpy()
            if emit == "mask":
                acc["out_sparse"] += mask_np.size
                local = np.argwhere(mask_np)
                n_pairs = len(local)
            if len(local):
                r_out.append(R.ids[start + local[:, 0]].astype(np.int64))
                s_out.append(Ss.ids[local[:, 1]].astype(np.int64))
            acc["n_pairs"] += n_pairs

    if res is None:
        in_flight: dict | None = None
        for start in range(0, m, r_block):
            # block k+1 launches before block k syncs
            blk = dispatch(start, min(start + r_block, m), acc)
            if in_flight is not None:
                finalize(in_flight, acc, r_out, s_out)
            if double_buffer:
                in_flight = blk
            else:
                finalize(blk, acc, r_out, s_out)
        if in_flight is not None:
            finalize(in_flight, acc, r_out, s_out)
    else:
        # resilience path (DESIGN.md §12): per-R-block tasks, run
        # synchronously under the retry + degradation ladder so a retry
        # can never double-count a block's stats or pairs
        from .join import brute_force_join  # deferred: the oracle rung
        if res.ledger.dir:
            res.ledger.open_run({
                "version": 1, "driver": "cf_rs_join_device", "t": float(t),
                "method": method, "emit": emit, "measure": measure,
                "r_block": int(r_block),
                "R": collection_digest(R), "S": collection_digest(S)})

        def fold(delta: dict) -> None:
            for k, v in delta.items():
                if k in acc and isinstance(v, (int, float)) \
                        and not isinstance(v, bool):
                    acc[k] = max(acc[k], v) if k == "walk_vmem" \
                        else acc[k] + v

        def primary(a: int, b: int):
            sub_acc, ro, so = zero_acc(), [], []
            if family == "lfvt":
                checked_flat(s_rep)  # injected-corruption detection site
            finalize(dispatch(a, b, sub_acc), sub_acc, ro, so)
            got = (np.stack([np.concatenate(ro), np.concatenate(so)], 1)
                   if ro else np.zeros((0, 2), np.int64))
            return sorted_pairs(got), sub_acc

        def oracle(a: int, b: int):
            subR = SetCollection([R.sets[i] for i in range(a, b)],
                                 R.universe, R.ids[a:b].astype(np.int32))
            got = brute_force_join(subR, S, t, measure=measure)
            sub_acc = zero_acc()
            sub_acc["n_pairs"] = len(got)
            return sorted_pairs(got), sub_acc

        budget = resolve_guardrail_budget(device)
        for start in range(0, m, r_block):
            stop = min(start + r_block, m)
            spans = [(start, stop)]
            if global_config.memory_guardrail:
                # pre-dispatch guardrail: the dense (mb, n) count tile is
                # the block's dominant device working set
                est = (stop - start) * len(Ss) * 4
                if est > budget:
                    k = min(stop - start, -(-est // budget))
                    cuts = np.linspace(start, stop, k + 1).astype(int)
                    spans = [(int(cuts[i]), int(cuts[i + 1]))
                             for i in range(k) if cuts[i + 1] > cuts[i]]
                    res.guardrail_splits += len(spans) - 1
            for a, b in spans:
                tid = f"device_join/{method}/{emit}/{measure}/rows={a}-{b}"
                got, delta = res.run(
                    tid, [(method, functools.partial(primary, a, b)),
                          ("oracle", functools.partial(oracle, a, b))])
                if len(got):
                    r_out.append(got[:, 0])
                    s_out.append(got[:, 1])
                fold(delta)

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
        if kernel_pairs or family == "lfvt":
            stats["live_tiles"] = acc["live"]
            stats["total_tiles"] = acc["total_tiles"]
        if method == "lfvt":
            stats["walk_steps"] = acc["walk_steps"]
            stats["early_stops"] = acc["early_stops"]
            stats["walk_vmem_tile_bytes"] = acc["walk_vmem"]
        if family == "lfvt":
            # the §9 memory axis: what the flat S rep holds on the device
            # vs what the bitmap sheet would have cost at this universe
            stats["s_flat_bytes"] = s_rep.nbytes()
            stats["s_flat_seq_bytes"] = int(s_rep.seq_row.nbytes)
            stats["s_bitmap_bytes_equiv"] = len(Ss) * W * 4
        resilience_stats(stats, res)
    if not r_out:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    return np.concatenate(r_out), np.concatenate(s_out)

