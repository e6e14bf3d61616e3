"""Padding, tile schedules, dispatch and pair emission around the kernels.

The port of the JAX package's ``kernels/ops.py``. A join block is
dispatched (``*_dispatch``: the host plans the live tiles, the device
runs the kernel; nothing is synchronised) and later finalized
(``join_pairs_finalize``: one device-to-host copy of the per-tile counts
and counters, then an on-device compaction of the qualifying pairs into a
power-of-two capacity buffer whose rows past the true count are
(-1, -1)). The ``PendingPairs`` handle between the two halves lets a
driver launch block k+1 before it waits for block k. The one-call
wrappers (``join_pairs`` by family name, ``lfvt_join_pairs``,
``lfvt_walk_join_pairs``, ``lfvt_walk_join_mask``) are the two halves
back to back.

``bitmap_join`` / ``onehot_join`` take unpadded operands (the layout the
driver stages), pad them to tile multiples, derive the tile-level skip
mask from the per-row windows (Theorem 3.3 at tile granularity), run the
dense kernel (K3 / K5) and slice the (m, n) bool mask back.
``bitmap_join_pairs`` / ``onehot_join_pairs`` are the sparse path: the
host compacts the skip criterion into live (i, j) tiles, the live-tile
kernel (K2 / K4) computes per-tile masks and exact counts, and only the
packed pairs come back. The LFVT walk rides the same protocol: K1 on the
host's live-tile list, or K6 on a plan made on the device
(``schedule="device"``), which leaves dispatch free of any wait for
the device. ``flash_attention`` hands the model's (B, L, H, D) queries
and (B, L, KV, D) keys and values to K7 as they are: no copy, no
expansion of the KV heads.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.config import global_config
from ..core.device import upload
from ..core.resilience import fault_point
from ..core.tile_join import PAIR_CAP_GRAIN, round_capacity
from . import bitmap_join as _bj
from . import flash_attention as _fa
from . import lfvt_walk as _lw
from . import onehot_join as _oj

__all__ = ["PendingPairs", "pick_tiles", "pad_sheet", "bitmap_join",
           "onehot_join", "bitmap_join_pairs", "onehot_join_pairs",
           "join_pairs", "round_capacity", "PAIR_CAP_GRAIN",
           "bitmap_join_pairs_dispatch", "onehot_join_pairs_dispatch",
           "lfvt_join_pairs", "lfvt_join_pairs_dispatch",
           "lfvt_walk_join_pairs", "lfvt_walk_join_pairs_dispatch",
           "lfvt_walk_join_mask", "join_pairs_finalize",
           "join_mask_finalize", "walk_operands", "flash_attention",
           "flash_attention_ref"]


def pick_tiles(m: int, n: int, w: int, defaults) -> tuple[int, int, int]:
    """Shrink default tiles for small problems (pads at most 2x)."""
    TM, TN, TW = defaults

    def shrink(size, tile, floor):
        while tile > floor and tile // 2 >= size:
            tile //= 2
        return tile
    return shrink(m, TM, 8), shrink(n, TN, 128), shrink(w, TW, 1)


def _pad_to(x: torch.Tensor, axis: int, mult: int, value=0) -> torch.Tensor:
    pad = (-x.shape[axis]) % mult
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, torch.full(shape, value, dtype=x.dtype,
                                    device=x.device)], dim=axis)


def _tile_skip_mask(lo, hi, m_tiles, n_tiles, tm, tn) -> torch.Tensor:
    """(m_tiles, n_tiles) int32: 1 if the tile is fully outside all windows.

    Tile (i, j) covers columns [j*tn, (j+1)*tn). It can be skipped iff for
    every row in the tile, the window [lo, hi) misses that column range —
    conservatively: min(lo) >= tile_end or max(hi) <= tile_start.
    """
    tile_lo = lo.reshape(m_tiles, tm).amin(dim=1)
    tile_hi = hi.reshape(m_tiles, tm).amax(dim=1)
    starts = torch.arange(n_tiles, dtype=torch.int32, device=lo.device) * tn
    ends = starts + tn
    skip = ((tile_lo[:, None] >= ends[None, :])
            | (tile_hi[:, None] <= starts[None, :]))
    return skip.to(torch.int32)


def _live_tiles(lo_p, hi_p, m_tiles, n_tiles, tm, tn):
    """Host-side skip-mask compaction -> live (i, j) tile coordinate lists.

    Same conservative criterion as ``_tile_skip_mask``, evaluated in numpy
    so the live list exists before kernel launch (it sizes the grid).
    Returns two (L,) int32 arrays, row-major tile order. Raises
    ``lfvt_walk.TileShapeError`` when the padded row count does not fill
    ``m_tiles`` tiles (a ragged tail would silently mis-plan).
    """
    if _lw._check_tile_rows(np.shape(lo_p)[0], tm, "_live_tiles") != m_tiles:
        raise _lw.TileShapeError(
            f"_live_tiles: {np.shape(lo_p)[0]} window rows do not fill "
            f"{m_tiles} row tiles of {tm}")
    tile_lo = np.asarray(lo_p).reshape(m_tiles, tm).min(axis=1)
    tile_hi = np.asarray(hi_p).reshape(m_tiles, tm).max(axis=1)
    starts = np.arange(n_tiles, dtype=np.int64) * tn
    live = (tile_lo[:, None] < starts[None, :] + tn) & (
        tile_hi[:, None] > starts[None, :])
    ti, tj = np.nonzero(live)
    return ti.astype(np.int32), tj.astype(np.int32)


def _rows(x, device) -> torch.Tensor:
    """A 1-D host array or tensor of row values -> int32 tensor on
    ``device``."""
    if torch.is_tensor(x):
        return x.to(device=device, dtype=torch.int32)
    return torch.tensor(np.asarray(x), dtype=torch.int32, device=device)


def _host_rows(x, mult: int) -> np.ndarray:
    """Row values on the host (a device tensor is copied back), padded with
    zeros to a multiple of ``mult``: the empty ``[0, 0)`` window."""
    x = x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
    return np.concatenate([x.reshape(-1).astype(np.int64),
                           np.zeros((-len(x)) % mult, np.int64)])


def pad_sheet(s_bitmaps: torch.Tensor) -> torch.Tensor:
    """The (n, W) S sheet padded as every launch against it pads it (TN
    and TW of ``pick_tiles``, the same for both families' defaults): the
    driver keeps it so, and ``_pad_operands`` then takes a view of it for
    each R block instead of a copy."""
    n, w = s_bitmaps.shape
    _, TN, TW = pick_tiles(1, n, w, _bj.DEFAULT_TILES)
    return _pad_to(_pad_to(s_bitmaps, 0, TN), 1, TW).contiguous()


def _pad_operands(r_bitmaps, r_sizes, s_bitmaps, s_sizes, lo, hi, tiles,
                  defaults):
    """Pad the operands of a tiled kernel to tile multiples (zero words,
    zero sizes, and the empty window [0, 0) for padded rows, which can
    never qualify) -> (rb, r_sz (M, 1), sb, s_sz (1, N), lo (M, 1),
    hi (M, 1), tiles, m, n), all int32 on the bitmaps' device.

    n is the number of S sizes; the sheet may hold more rows (the
    padding ``pad_sheet`` keeps, outside every window), and a sheet
    already padded as far as the tiles need is used as it is, not
    copied."""
    m, w = r_bitmaps.shape
    n = s_sizes.numel() if torch.is_tensor(s_sizes) else np.size(s_sizes)
    device = r_bitmaps.device
    TM, TN, TW = tiles if tiles is not None else pick_tiles(m, n, w, defaults)
    rb = _pad_to(_pad_to(r_bitmaps, 0, TM), 1, TW).contiguous()
    N = -(-n // TN) * TN
    sb = s_bitmaps[:N] if s_bitmaps.shape[0] >= N else s_bitmaps
    sb = _pad_to(_pad_to(sb, 0, TN), 1, TW).contiguous()
    r_sz = _pad_to(_rows(r_sizes, device), 0, TM).reshape(-1, 1)
    s_sz = _pad_to(_rows(s_sizes, device), 0, TN).reshape(1, -1)
    lo_p = _pad_to(_rows(lo, device), 0, TM).reshape(-1, 1)
    hi_p = _pad_to(_rows(hi, device), 0, TM).reshape(-1, 1)
    return rb, r_sz, sb, s_sz, lo_p, hi_p, (TM, TN, TW), m, n


def _prepare(r_bitmaps, r_sizes, s_bitmaps, s_sizes, lo, hi, tiles, defaults):
    rb, r_sz, sb, s_sz, lo_p, hi_p, tls, m, n = _pad_operands(
        r_bitmaps, r_sizes, s_bitmaps, s_sizes, lo, hi, tiles, defaults)
    TM, TN, _ = tls
    m_tiles, n_tiles = rb.shape[0] // TM, sb.shape[0] // TN
    skip = _tile_skip_mask(lo_p[:, 0], hi_p[:, 0], m_tiles, n_tiles, TM, TN)
    return rb, r_sz, sb, s_sz, lo_p, hi_p, skip, tls, m, n


def _pack_bitmaps(padded: torch.Tensor, universe: int) -> torch.Tensor:
    """(rows, L) int32 element lists (-1 pad) -> (rows, W) bitmaps as int32
    tensors holding the uint32 bits.

    Elements within a set are unique, so each (word, bit) target is hit at
    most once and a scatter-add of single-bit values equals a scatter-or.
    """
    W = max((universe + 31) // 32, 1)
    padded = padded.long()
    valid = padded >= 0
    word = torch.where(valid, padded // 32, 0)
    bit = torch.where(valid, torch.ones_like(padded) << (padded % 32), 0)
    out = torch.zeros((padded.shape[0], W), dtype=torch.int64,
                      device=padded.device)
    out.scatter_add_(1, word, bit)
    return torch.where(out >= 2 ** 31, out - 2 ** 32, out).to(torch.int32)


def _coerce_bitmaps(r_in, s_in, universe):
    """Both operands as bitmaps of one word width.

    The reference tells element lists from bitmaps by dtype (int32 against
    uint32); the port holds bitmap words in int32 tensors, so the caller
    says which: with ``universe`` given, the operands are -1-padded
    element lists over [0, universe) and are packed first.
    """
    if universe is not None:
        r_in = _pack_bitmaps(r_in, universe)
        s_in = _pack_bitmaps(s_in, universe)
    W = max(r_in.shape[1], s_in.shape[1])
    return _pad_to(r_in, 1, W), _pad_to(s_in, 1, W)


# ---------------------------------------------------------------------- #
# dense-mask path
# ---------------------------------------------------------------------- #
def bitmap_join(r_bitmaps, r_sizes, s_bitmaps, s_sizes, lo, hi, t: float,
                tiles=None, measure: str = "jaccard",
                s_sparse=None) -> torch.Tensor:
    """(m, n) bool qualifying-pair matrix via the popcount kernel (K3).

    ``r_bitmaps`` (m, W) and ``s_bitmaps`` (n, W), or ``pad_sheet`` of
    it, are int32 tensors with the uint32 bits on one device; sizes and
    windows are host arrays or tensors. ``s_sparse`` is the sheet's
    ``bitmap_join.compress_s``, which the kernel reads S through (built
    per call when None). The result lies on the bitmaps' device.
    """
    rb, r_sz, sb, s_sz, lo_p, hi_p, skip, tls, m, n = _prepare(
        r_bitmaps, r_sizes, s_bitmaps, s_sizes, lo, hi, tiles,
        _bj.DEFAULT_TILES)
    out = _bj.bitmap_join_tiled(rb, r_sz, sb, s_sz, lo_p, hi_p, skip, t=t,
                                measure=measure, tiles=tls,
                                s_sparse=s_sparse)
    return out[:m, :n]


def onehot_join(r_bitmaps_or_padded, r_sizes, s_bitmaps, s_sizes, lo, hi,
                t: float, universe: int | None = None, tiles=None,
                measure: str = "jaccard") -> torch.Tensor:
    """(m, n) bool qualifying-pair matrix via the one-hot kernel (K5).

    Takes bitmaps as ``bitmap_join`` does, or -1-padded element lists
    when ``universe`` is given (see ``_coerce_bitmaps``).
    """
    r_in, s_in = _coerce_bitmaps(r_bitmaps_or_padded, s_bitmaps, universe)
    rb, r_sz, sb, s_sz, lo_p, hi_p, skip, tls, m, n = _prepare(
        r_in, r_sizes, s_in, s_sizes, lo, hi, tiles, _oj.DEFAULT_TILES)
    out = _oj.onehot_join_tiled(rb, r_sz, sb, s_sz, lo_p, hi_p, skip, t=t,
                                measure=measure, tiles=tls)
    return out[:m, :n]


# ---------------------------------------------------------------------- #
# sparse pair emission (live-tile schedule + on-device compaction)
# ---------------------------------------------------------------------- #
def _compact_live(mask_tiles: torch.Tensor, tile_i: torch.Tensor,
                  tile_j: torch.Tensor, *, tm: int, tn: int,
                  size: int) -> torch.Tensor:
    """(L, TM, TN) live-tile masks -> packed (size, 2) int32 global pairs,
    row-major. Rows past the true pair count are (-1, -1): the capacity
    padding of the reference's ``jnp.nonzero(size=, fill_value=-1)``,
    kept so ``pair_bytes = size * 8`` means the same buffer."""
    idx = torch.nonzero_static(mask_tiles, size=size, fill_value=-1)
    l, r, c = idx[:, 0], idx[:, 1], idx[:, 2]
    valid = l >= 0
    safe = torch.where(valid, l, 0)
    rows = torch.where(valid, tile_i[safe].long() * tm + r, -1)
    cols = torch.where(valid, tile_j[safe].long() * tn + c, -1)
    return torch.stack([rows, cols], dim=1).to(torch.int32)


@dataclasses.dataclass
class PendingPairs:
    """In-flight sparse join: device work dispatched, counts not synced.

    Produced by ``*_join_pairs_dispatch`` and resolved by
    ``join_pairs_finalize`` / ``join_mask_finalize``.
    """

    masks: torch.Tensor | None   # (L, TM, TN) staged qualifying sub-masks
    counts: torch.Tensor | None  # (L, 1) exact per-tile pair counts
    tile_i: torch.Tensor | None  # (L,) live tile rows
    tile_j: torch.Tensor | None  # (L,) live tile cols
    tm: int
    tn: int
    live_tiles: int
    total_tiles: int
    dense_mask_bytes: int
    # kernel counters (the walk's walk_steps / early_stops as (L, 1)
    # device tensors, plus host ints); summed into stats at finalize
    extras: dict | None = None
    # packed-row remap: the walk sorts R rows by size so row tiles hold
    # near-identical windows; row_map[packed_row] is the original block
    # row (-1 for tile padding)
    row_map: torch.Tensor | None = None


def _sync_counts(pending: PendingPairs, stats: dict | None) -> np.ndarray:
    """The one device-to-host copy of a finalize: the per-tile counts and
    every tensor extra (per-tile counters and scalars such as the device
    schedule's live count), flattened into one buffer; folds each
    extra's sum and the schedule into ``stats``. Returns the (L,)
    per-tile counts."""
    L = pending.live_tiles
    extras = pending.extras or {}
    keys = [k for k, v in extras.items() if torch.is_tensor(v)]
    parts = ([pending.counts] if L else []) + [extras[k] for k in keys]
    host = (torch.cat([x.reshape(-1) for x in parts]).cpu().numpy()
            if parts else np.zeros(0, np.int64))
    if stats is not None:
        stats["live_tiles"] = L
        stats["total_tiles"] = pending.total_tiles
        stats["dense_mask_bytes"] = pending.dense_mask_bytes
        at = L
        for key, val in extras.items():
            if key in keys:
                n = val.numel()
                stats[key] = int(host[at:at + n].sum())
                at += n
            else:
                stats[key] = int(val)
    return host[:L]


def join_pairs_finalize(pending: PendingPairs, capacity: int | None = None,
                        stats: dict | None = None):
    """Sync a dispatched join's counts and compact -> (pairs, n_pairs).

    ``pairs`` is a (cap, 2) int32 device tensor; its first ``n_pairs``
    rows are the qualifying (row, col) indices into the unpadded block,
    the rest (-1, -1).
    """
    fault_point("compact")
    counts = _sync_counts(pending, stats)
    L = pending.live_tiles
    device = pending.masks.device if pending.masks is not None else "cpu"
    if L == 0:
        if stats is not None:
            stats.update(pair_count=0, pair_bytes=0, counts_bytes=0,
                         output_bytes=0, regrows=0)
        return torch.zeros((0, 2), dtype=torch.int32), 0
    # per-tile counts are exact even when a capacity hint is too small:
    # they give the regrown capacity without a second kernel pass
    total = int(counts.sum())
    cap = round_capacity(total if capacity is None else capacity)
    regrows = 0
    if cap < total:  # overflow: regrow to the exact requirement
        fault_point("regrow")
        cap = round_capacity(total)
        regrows += 1
    if cap:
        pairs = _compact_live(pending.masks, pending.tile_i, pending.tile_j,
                              tm=pending.tm, tn=pending.tn, size=cap)
        if pending.row_map is not None:
            pairs = _remap_rows(pairs, pending.row_map)
    else:
        pairs = torch.zeros((0, 2), dtype=torch.int32, device=device)
    if stats is not None:
        stats["pair_count"] = total
        stats["pair_bytes"] = cap * 8          # what the packed array ships
        stats["counts_bytes"] = L * 4          # per-tile count transfer
        stats["output_bytes"] = cap * 8 + L * 4
        stats["regrows"] = regrows
    return pairs, total


def _remap_rows(pairs: torch.Tensor, row_map: torch.Tensor) -> torch.Tensor:
    """Translate packed pair rows through ``row_map`` (-1 pads kept)."""
    r = pairs[:, 0]
    valid = r >= 0
    rows = torch.where(valid, row_map[torch.where(valid, r, 0).long()], -1)
    return torch.stack([rows.to(torch.int32), pairs[:, 1]], dim=1)


def join_mask_finalize(pending: PendingPairs, m: int, n: int,
                       stats: dict | None = None) -> np.ndarray:
    """Resolve a dispatched join into the dense (m, n) bool host mask.

    The staged live-tile sub-masks are scattered back onto the full
    row-tile grid (skipped tiles stay all-False — their windows are
    empty), the dispatch's size sort is undone through ``row_map``, and
    the padding is sliced off.
    """
    fault_point("compact")
    _sync_counts(pending, stats)
    L = pending.live_tiles
    if L == 0:
        return np.zeros((m, n), bool)
    masks = pending.masks.cpu().numpy()  # (L, tm, NP)
    tm = pending.tm
    ti = pending.tile_i.cpu().numpy()
    full = np.zeros((pending.total_tiles * tm, masks.shape[2]), bool)
    full.reshape(pending.total_tiles, tm, -1)[ti] = masks
    if pending.row_map is None:
        return full[:m, :n]
    out = np.zeros((m, n), bool)
    rm = pending.row_map.cpu().numpy()
    valid = rm >= 0
    out[rm[valid]] = full[valid][:, :n]
    return out


def _join_pairs_dispatch(live_fn, defaults, r_bitmaps, r_sizes, s_bitmaps,
                         s_sizes, lo, hi, t, tiles, measure="jaccard",
                         **live_kw) -> PendingPairs:
    """Launch the live-tile kernel ``live_fn`` (``live_kw`` its extra
    keywords); return the device handles without syncing. The live tiles
    are planned from host copies of the windows (the driver passes host
    arrays, so nothing syncs)."""
    fault_point("walk_dispatch")
    rb, r_sz, sb, s_sz, lo_p, hi_p, tls, m, n = _pad_operands(
        r_bitmaps, r_sizes, s_bitmaps, s_sizes, lo, hi, tiles, defaults)
    TM, TN, _ = tls
    m_tiles, n_tiles = rb.shape[0] // TM, sb.shape[0] // TN
    ti, tj = _live_tiles(_host_rows(lo, TM), _host_rows(hi, TM), m_tiles,
                         n_tiles, TM, TN)
    L = len(ti)
    if L == 0:
        return PendingPairs(None, None, None, None, TM, TN, 0,
                            m_tiles * n_tiles, m * n)
    ti_d = torch.as_tensor(ti, device=rb.device)
    tj_d = torch.as_tensor(tj, device=rb.device)
    masks, counts = live_fn(ti_d, tj_d, rb, r_sz, sb, s_sz, lo_p, hi_p, t=t,
                            measure=measure, tiles=tls, **live_kw)
    return PendingPairs(masks, counts, ti_d, tj_d, TM, TN, L,
                        m_tiles * n_tiles, m * n)


def lfvt_walk_join_mask(flat, r_padded: torch.Tensor, r_sizes, lo, hi,
                        t: float, measure: str = "jaccard",
                        row_tile: int | None = None,
                        stats: dict | None = None,
                        schedule: str = "host") -> np.ndarray:
    """Dense-mask flat-LFVT join through the walk kernel (K1, or K6 with
    ``schedule="device"``): the dispatch of ``lfvt_walk_join_pairs``
    (walk counters included), resolved by ``join_mask_finalize``."""
    pending = lfvt_walk_join_pairs_dispatch(
        flat, r_padded, r_sizes, lo, hi, t, measure=measure,
        row_tile=row_tile, schedule=schedule)
    return join_mask_finalize(pending, int(r_padded.shape[0]), flat.n_sets,
                              stats)


def _join_pairs(live_fn, defaults, r_bitmaps, r_sizes, s_bitmaps, s_sizes,
                lo, hi, t, tiles, capacity, stats, measure="jaccard"):
    pending = _join_pairs_dispatch(live_fn, defaults, r_bitmaps, r_sizes,
                                   s_bitmaps, s_sizes, lo, hi, t, tiles,
                                   measure)
    return join_pairs_finalize(pending, capacity, stats)


def bitmap_join_pairs(r_bitmaps, r_sizes, s_bitmaps, s_sizes, lo, hi,
                      t: float, tiles=None, capacity: int | None = None,
                      stats: dict | None = None, measure: str = "jaccard"):
    """Sparse popcount join (K2) -> (pairs (P, 2) int32 device tensor,
    n_pairs).

    ``pairs[:n_pairs]`` are the qualifying (row, col) indices into the
    unpadded operands; later rows are (-1, -1) capacity padding. P is
    ``capacity`` rounded up (regrown on overflow — the per-tile counts
    make the retry exact, never a second kernel pass).
    """
    return _join_pairs(_bj.bitmap_join_live_tiled, _bj.DEFAULT_TILES,
                       r_bitmaps, r_sizes, s_bitmaps, s_sizes, lo, hi, t,
                       tiles, capacity, stats, measure)


def onehot_join_pairs(r_bitmaps_or_padded, r_sizes, s_bitmaps, s_sizes, lo,
                      hi, t: float, universe: int | None = None, tiles=None,
                      capacity: int | None = None, stats: dict | None = None,
                      measure: str = "jaccard"):
    """Sparse one-hot join (K4); the contract of ``bitmap_join_pairs``."""
    r_in, s_in = _coerce_bitmaps(r_bitmaps_or_padded, s_bitmaps, universe)
    return _join_pairs(_oj.onehot_join_live_tiled, _oj.DEFAULT_TILES, r_in,
                       r_sizes, s_in, s_sizes, lo, hi, t, tiles, capacity,
                       stats, measure)


def bitmap_join_pairs_dispatch(r_bitmaps, r_sizes, s_bitmaps, s_sizes, lo,
                               hi, t: float, tiles=None,
                               measure: str = "jaccard",
                               s_sparse=None) -> PendingPairs:
    """Async half of ``bitmap_join_pairs``: launch, don't sync;
    ``s_sparse`` as in ``bitmap_join``."""
    return _join_pairs_dispatch(_bj.bitmap_join_live_tiled, _bj.DEFAULT_TILES,
                                r_bitmaps, r_sizes, s_bitmaps, s_sizes, lo,
                                hi, t, tiles, measure, s_sparse=s_sparse)


def onehot_join_pairs_dispatch(r_bitmaps_or_padded, r_sizes, s_bitmaps,
                               s_sizes, lo, hi, t: float,
                               universe: int | None = None, tiles=None,
                               measure: str = "jaccard") -> PendingPairs:
    """Async half of ``onehot_join_pairs``: launch, don't sync."""
    r_in, s_in = _coerce_bitmaps(r_bitmaps_or_padded, s_bitmaps, universe)
    return _join_pairs_dispatch(_oj.onehot_join_live_tiled, _oj.DEFAULT_TILES,
                                r_in, r_sizes, s_in, s_sizes, lo, hi, t,
                                tiles, measure)


def lfvt_join_pairs_dispatch(flat, r_padded: torch.Tensor, r_sizes, lo, hi,
                             t: float, measure: str = "jaccard"
                             ) -> PendingPairs:
    """Whole-block flat-LFVT walk (the ``lfvt_ref`` method) as one live
    tile of the ``PendingPairs`` protocol."""
    from ..core.lfvt_flat import flat_join_mask  # deferred: no cycle
    fault_point("walk_dispatch")
    mb, n = r_padded.shape[0], flat.n_sets
    if mb == 0 or n == 0:
        return PendingPairs(None, None, None, None, max(mb, 1), max(n, 1),
                            0, 1, mb * n)
    mask = flat_join_mask(flat, r_padded, r_sizes, lo, hi, t, measure)
    counts = mask.sum(dtype=torch.int32).reshape(1, 1)
    zero = torch.zeros(1, dtype=torch.int32, device=mask.device)
    return PendingPairs(mask[None], counts, zero, zero, mb, n, 1, 1, mb * n)


def walk_operands(flat, r_padded: torch.Tensor, r_sizes, lo, hi, tm: int,
                  schedule: str = "host"):
    """The walk kernel's operands for one R block, on ``r_padded``'s
    device: ``(plan, (lane_pos, lane_rem, nxt2d, seq2d, ssz2d, rsz, lo,
    hi), row_map)``.

    The rows are sorted by set size (stable; rows with near-identical
    windows share a tile) and padded to whole ``tm``-row tiles with empty
    ``[0, 0)`` windows; ``row_map[packed_row]`` is the block row (-1 for
    padding). With ``schedule="host"`` the plan is ``ti``, the live tiles
    listed on the host (``plan_row_tiles``), and the result is None when
    no row tile has a live window. With ``schedule="device"`` the plan is
    ``(ti_sorted, n_live)`` from ``plan_row_tiles_device``, left on the
    device: nothing here waits for the device.
    """
    device = r_padded.device
    dev = flat.to_device(device)
    m = r_padded.shape[0]
    order = np.argsort(-np.asarray(r_sizes), kind="stable").astype(np.int32)
    pad_rows = (-m) % tm
    lo_p = np.concatenate(
        [np.asarray(lo)[order], np.zeros(pad_rows, np.int64)])
    hi_p = np.concatenate(
        [np.asarray(hi)[order], np.zeros(pad_rows, np.int64)])
    sz_p = np.concatenate(
        [np.asarray(r_sizes)[order], np.zeros(pad_rows, np.int64)])
    if schedule == "host":
        ti = _lw.plan_row_tiles(lo_p, hi_p, tm)
        if len(ti) == 0:
            return None
    r_perm = _pad_to(r_padded[upload(order, device).long()], 0, tm, -1)
    lane_pos, lane_rem = _lw.entry_state(dev, r_perm)
    seq2d = _pad_to(dev.seq_row.reshape(1, -1), 1, global_config.col_pad)
    nxt2d = _pad_to(dev.seq_next.reshape(1, -1), 1, global_config.col_pad)
    ssz2d = _pad_to(dev.s_sizes.reshape(1, -1), 1, global_config.col_pad)

    def rows(x):
        return upload(x.astype(np.int32).reshape(-1, 1), device)

    row_map = upload(
        np.concatenate([order, np.full(pad_rows, -1, np.int32)]), device)
    operands = (lane_pos, lane_rem, nxt2d, seq2d, ssz2d, rows(sz_p),
                rows(lo_p), rows(hi_p))
    if schedule == "host":
        plan = upload(ti, device)
    else:
        plan = _lw.plan_row_tiles_device(operands[-2], operands[-1], tm)
    return plan, operands, row_map


def lfvt_walk_join_pairs_dispatch(flat, r_padded: torch.Tensor, r_sizes,
                                  lo, hi, t: float,
                                  measure: str = "jaccard",
                                  row_tile: int | None = None,
                                  schedule: str = "host") -> PendingPairs:
    """Flat-LFVT walk as a row-tiled kernel dispatch.

    ``r_padded`` is the (m, Lr) -1-padded R block on the device the walk
    runs on; ``r_sizes``/``lo``/``hi`` are host numpy rows. The block is
    sorted by set size (stable) and padded to whole ``row_tile`` tiles
    with empty ``[0, 0)`` windows (``walk_operands``).

    schedule: 'host' (default) — the host lists the live tiles and only
          those launch (K1); 'device' — ``plan_row_tiles_device`` plans
          on the device and the planned walk (K6) runs the full tile
          range, dead tiles zeroed, so dispatch never waits for the
          device; the live count rides to finalize in
          ``extras['live_tiles']``. Masks, pairs and counters are equal
          across schedules.
    """
    fault_point("walk_dispatch")
    if schedule not in ("host", "device"):
        raise ValueError(f"unknown walk schedule {schedule!r}")
    tm = row_tile or global_config.row_tile
    m, Lr = r_padded.shape
    n = flat.n_sets
    m_tiles = max(-(-m // tm), 1)
    if (m == 0 or n == 0 or Lr == 0 or len(flat.entry_elem) == 0
            or flat.max_seq_len == 0):
        return PendingPairs(None, None, None, None, tm, max(n, 1), 0,
                            m_tiles, m * n)
    plan = walk_operands(flat, r_padded, r_sizes, lo, hi, tm, schedule)
    if plan is None:
        return PendingPairs(None, None, None, None, tm, n, 0, m_tiles, m * n)
    ti, operands, row_map = plan
    kw = dict(t=t, measure=measure, max_steps=int(flat.max_seq_len), tm=tm)
    ssz2d, seq2d = operands[4], operands[3]
    extras = {
        # host int: the per-tile working set by the reference's accounting
        "walk_vmem_tile_bytes": _lw.walk_vmem_tile_bytes(
            tm, Lr, ssz2d.shape[1], seq2d.shape[1])}
    if schedule == "device":
        ti_sorted, n_live = ti
        masks, counts, steps, stops = _lw.lfvt_walk_planned(
            ti_sorted, n_live, *operands, **kw)
        L = m_tiles
        tile_i = torch.arange(L, dtype=torch.int32, device=r_padded.device)
        extras["live_tiles"] = n_live
    else:
        masks, counts, steps, stops = _lw.lfvt_walk_live_tiled(
            ti, *operands, **kw)
        L, tile_i = len(ti), ti
    extras.update(walk_steps=steps, early_stops=stops)
    return PendingPairs(
        masks, counts, tile_i,
        torch.zeros(L, dtype=torch.int32, device=r_padded.device),
        tm, ssz2d.shape[1], L, m_tiles, m * n, extras=extras,
        row_map=row_map)


def lfvt_join_pairs(flat, r_padded: torch.Tensor, r_sizes, lo, hi,
                    t: float, capacity: int | None = None,
                    stats: dict | None = None, measure: str = "jaccard"):
    """Sparse whole-block flat-LFVT join (``lfvt_ref``); the contract of
    ``bitmap_join_pairs``."""
    pending = lfvt_join_pairs_dispatch(flat, r_padded, r_sizes, lo, hi, t,
                                       measure)
    return join_pairs_finalize(pending, capacity, stats)


def lfvt_walk_join_pairs(flat, r_padded: torch.Tensor, r_sizes, lo, hi,
                         t: float, capacity: int | None = None,
                         stats: dict | None = None,
                         measure: str = "jaccard",
                         row_tile: int | None = None,
                         schedule: str = "host"):
    """Sparse flat-LFVT join through the walk kernel (K1, or K6 with
    ``schedule="device"``); the contract of ``bitmap_join_pairs``."""
    pending = lfvt_walk_join_pairs_dispatch(
        flat, r_padded, r_sizes, lo, hi, t, measure=measure,
        row_tile=row_tile, schedule=schedule)
    return join_pairs_finalize(pending, capacity, stats)


def join_pairs(method: str, *args, **kw):
    """Sparse emission by family: 'bitmap' (K2), 'onehot' (K4), 'lfvt'
    (the walk kernel) or 'lfvt_ref' (the whole-block walk)."""
    if method == "bitmap":
        return bitmap_join_pairs(*args, **kw)
    if method == "onehot":
        return onehot_join_pairs(*args, **kw)
    if method == "lfvt":
        return lfvt_walk_join_pairs(*args, **kw)
    if method == "lfvt_ref":
        return lfvt_join_pairs(*args, **kw)
    raise ValueError(f"unknown pair-emission method {method!r}")


# ---------------------------------------------------------------------- #
# attention (K7)
# ---------------------------------------------------------------------- #
def flash_attention(q, k, v, window=None):
    """Causal flash attention. q (B, L, H, D); k, v (B, L, KV, D) with KV
    dividing H: query head h attends with KV head h // (H // KV), read in
    place (no expanded copy, no merged layout). The kernel masks the
    ragged edge itself, so nothing is padded. Inference only (no backward
    kernel)."""
    return _fa.flash_attention_blhd(q, k, v, scale=q.shape[-1] ** -0.5,
                                    window=window)


def flash_attention_ref(q, k, v, window=None):
    """Full-softmax oracle for the flash kernel (same masks, float32
    math), in the (B, L, H, D) layout; k, v may hold fewer (KV) heads, as
    in ``flash_attention``."""
    return _fa.flash_attention_blhd_ref(q, k, v, scale=q.shape[-1] ** -0.5,
                                        window=window)
