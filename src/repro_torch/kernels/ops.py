"""Dispatch, pair emission and mask emission around the walk kernel.

The port of the LFVT half of the JAX package's ``kernels/ops.py``. A
join block is dispatched (``*_dispatch``: the host plans the live row
tiles, the device runs the walk; nothing is synchronised) and later
finalized (``join_pairs_finalize``: one device-to-host copy of the
per-tile counts and walk counters, then an on-device compaction of the
qualifying pairs into a power-of-two capacity buffer whose rows past the
true count are (-1, -1)). The ``PendingPairs`` handle between the two
halves lets a driver launch block k+1 before it waits for block k.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.config import global_config
from ..core.resilience import fault_point
from ..core.tile_join import round_capacity
from ..errors import NotPortedError
from . import lfvt_walk as _lw

__all__ = ["PendingPairs", "lfvt_join_pairs_dispatch",
           "lfvt_walk_join_pairs_dispatch", "join_pairs_finalize",
           "join_mask_finalize", "walk_operands"]


def _pad_to(x: torch.Tensor, axis: int, mult: int, value=0) -> torch.Tensor:
    pad = (-x.shape[axis]) % mult
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, torch.full(shape, value, dtype=x.dtype,
                                    device=x.device)], dim=axis)


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
    every per-tile extra counter, stacked; folds the counters and the
    schedule into ``stats``. Returns the (L,) per-tile counts."""
    L = pending.live_tiles
    extras = pending.extras or {}
    keys = [k for k, v in extras.items() if torch.is_tensor(v)]
    host = np.zeros((L, 1 + len(keys)), np.int64)
    if L:
        host = torch.cat([pending.counts.reshape(L, 1)]
                         + [extras[k].reshape(L, 1) for k in keys],
                         dim=1).cpu().numpy()
    if stats is not None:
        stats["live_tiles"] = L
        stats["total_tiles"] = pending.total_tiles
        stats["dense_mask_bytes"] = pending.dense_mask_bytes
        for key, val in extras.items():
            stats[key] = (int(host[:, 1 + keys.index(key)].sum())
                          if key in keys else int(val))
    return host[:, 0]


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


def walk_operands(flat, r_padded: torch.Tensor, r_sizes, lo, hi, tm: int):
    """The walk kernel's operands for one R block, on ``r_padded``'s
    device: ``(ti, (lane_pos, lane_rem, nxt2d, seq2d, ssz2d, rsz, lo,
    hi), row_map)``, or None when no row tile has a live window.

    The rows are sorted by set size (stable; rows with near-identical
    windows share a tile) and padded to whole ``tm``-row tiles with empty
    ``[0, 0)`` windows; ``ti`` lists the live tiles (host plan) and
    ``row_map[packed_row]`` is the block row (-1 for padding).
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
    ti = _lw.plan_row_tiles(lo_p, hi_p, tm)
    if len(ti) == 0:
        return None
    r_perm = _pad_to(r_padded[torch.as_tensor(order, device=device).long()],
                     0, tm, -1)
    lane_pos, lane_rem = _lw.entry_state(dev, r_perm)
    seq2d = _pad_to(dev.seq_row.reshape(1, -1), 1, global_config.col_pad)
    nxt2d = _pad_to(dev.seq_next.reshape(1, -1), 1, global_config.col_pad)
    ssz2d = _pad_to(dev.s_sizes.reshape(1, -1), 1, global_config.col_pad)

    def rows(x):
        return torch.as_tensor(x.astype(np.int32).reshape(-1, 1),
                               device=device)

    row_map = torch.as_tensor(
        np.concatenate([order, np.full(pad_rows, -1, np.int32)]),
        device=device)
    return (torch.as_tensor(ti, device=device),
            (lane_pos, lane_rem, nxt2d, seq2d, ssz2d, rows(sz_p),
             rows(lo_p), rows(hi_p)), row_map)


def lfvt_walk_join_pairs_dispatch(flat, r_padded: torch.Tensor, r_sizes,
                                  lo, hi, t: float,
                                  measure: str = "jaccard",
                                  row_tile: int | None = None,
                                  schedule: str = "host") -> PendingPairs:
    """Flat-LFVT walk as a live row-tiled kernel dispatch.

    ``r_padded`` is the (m, Lr) -1-padded R block on the device the walk
    runs on; ``r_sizes``/``lo``/``hi`` are host numpy rows. The block is
    sorted by set size (stable), padded to whole ``row_tile`` tiles with
    empty ``[0, 0)`` windows, and the tiles with no live window are
    dropped before launch. ``schedule='device'`` (the reference's traced
    plan, kernel K6) is not ported yet and raises ``NotPortedError``.
    """
    fault_point("walk_dispatch")
    if schedule == "device":
        raise NotPortedError(
            "schedule='device' runs the planned walk (kernel K6 "
            "lfvt_walk_planned), which the PyTorch port does not have yet; "
            "use schedule='host'")
    if schedule != "host":
        raise ValueError(f"unknown walk schedule {schedule!r}")
    tm = row_tile or global_config.row_tile
    m, Lr = r_padded.shape
    n = flat.n_sets
    m_tiles = max(-(-m // tm), 1)
    if (m == 0 or n == 0 or Lr == 0 or len(flat.entry_elem) == 0
            or flat.max_seq_len == 0):
        return PendingPairs(None, None, None, None, tm, max(n, 1), 0,
                            m_tiles, m * n)
    plan = walk_operands(flat, r_padded, r_sizes, lo, hi, tm)
    if plan is None:
        return PendingPairs(None, None, None, None, tm, n, 0, m_tiles, m * n)
    ti, operands, row_map = plan
    masks, counts, steps, stops = _lw.lfvt_walk_live_tiled(
        ti, *operands, t=t, measure=measure,
        max_steps=int(flat.max_seq_len), tm=tm)
    ssz2d, seq2d = operands[4], operands[3]
    extras = {
        # host int: the per-tile working set by the reference's accounting
        "walk_vmem_tile_bytes": _lw.walk_vmem_tile_bytes(
            tm, Lr, ssz2d.shape[1], seq2d.shape[1]),
        "walk_steps": steps, "early_stops": stops}
    L = len(ti)
    return PendingPairs(
        masks, counts, ti,
        torch.zeros(L, dtype=torch.int32, device=r_padded.device),
        tm, ssz2d.shape[1], L, m_tiles, m * n, extras=extras,
        row_map=row_map)

