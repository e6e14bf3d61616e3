"""MR-CF-RS-Join: the paper's single MapReduce job.

The port of the JAX package's ``core/distributed.py`` (DESIGN.md §2, §7):

  map     -> host routing via ``core.partition`` (length-range, Eq. 2-3)
  shuffle -> the per-shard layout (``shard_blocks``, or each shard's
             compiled ``FlatLFVT``); bytes counted exactly
  reduce  -> per-shard candidate-free join on the device; with
             ``emit='pairs'`` each shard's qualifying pairs are compacted
             on the device into a power-of-two pair buffer plus an exact
             count, and only the count's rows come back.

Two execution paths share the shard-local compute:

  * the loop path (no ``mesh``): the shards run one after another on one
    device through the single-device kernels — the LFVT walk (K1) for
    ``lfvt`` shards, the popcount join (K3 dense, K2 live tiles) for the
    bitmap shards and the one-hot product (K5, K4) for
    ``kernel_onehot``. The reference's ``lax.map`` over a stacked bucket
    is a Python loop over its shards here;
  * the mesh path (``mesh=``, a ``launch.mesh.Mesh``): shard ``k`` of a
    stacked bucket runs on slot ``k``'s device, the counterpart of the
    reference's ``shard_map``. ``lfvt`` sentinel-pads each shard's flat
    tables into pow-2 buckets (``_lfvt_mesh_join``) and walks each shard
    with the device-planned walk (K6) or every tile (K1); the bitmap
    methods stack one globally padded block and run K3 (K5 for
    ``kernel_onehot``) per shard. Every shard of a bucket is launched
    before the host reads anything back, once per device.

With ``fault_plan=``/``checkpoint_dir=`` (or ``REPRO_FAULT``) each shard
(LFVT paths) or bucket (bitmap paths) is a task of the resilience ladder
(core/resilience.py, DESIGN.md §12), with the reference's task ids, rungs
and counters.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools

import numpy as np
import torch

from ..launch.mesh import Mesh, check_mesh, join_axis
from .config import global_config, resolve_guardrail_budget
from .device import resolve_device, upload
from .measures import get_measure
from .partition import Partitioning, hash_partition, load_aware_partition, route
from .planner import build_plan, validate_join_args
from .resilience import (build_resilience, checked_flat, collection_digest,
                         fault_point, resilience_stats, sorted_pairs)
from .sets import EmptyCollectionError, SetCollection
from .tile_join import _compact_mask, _mask_total, round_capacity, window_bounds

__all__ = ["mr_cf_rs_join", "shard_blocks", "local_join_mask", "ShardBlock"]


def _words(a: np.ndarray, device) -> torch.Tensor:
    """uint32 bitmap words -> an int32 tensor with the same bits on
    ``device`` (the layout the popcount and one-hot kernels read)."""
    return upload(np.ascontiguousarray(a).view(np.int32), device)


def _on(device):
    """Make ``device`` the current CUDA device while a shard's kernels
    launch (they run on the current device's stream); a no-op on the
    CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _host(tensors) -> list[np.ndarray]:
    """Copy device tensors to the host with one wait per device: every
    copy is queued first (into pinned memory, without blocking), then
    each device is synchronised once."""
    outs = [x.to("cpu", non_blocking=True) for x in tensors]
    for dev in {x.device for x in tensors if x.device.type == "cuda"}:
        torch.cuda.synchronize(dev)
    return [o.numpy() for o in outs]


def _place(arrays, devices) -> list[list[torch.Tensor]]:
    """Stacked host arrays (leading dim K) -> per shard the list of its
    rows as tensors, shard ``k``'s on ``devices[k]``: one upload of each
    array per device, however many slots share it."""
    out = [[None] * len(arrays) for _ in devices]
    slots: dict = {}
    for k, dev in enumerate(devices):
        slots.setdefault(dev, []).append(k)
    for dev, ks in slots.items():
        for i, a in enumerate(arrays):
            up = upload(a[ks], dev)
            for j, k in enumerate(ks):
                out[k][i] = up[j]
    return out


# ---------------------------------------------------------------------- #
# shard-local compute
# ---------------------------------------------------------------------- #
def local_join_mask(r_bm, r_sz, s_bm, s_sz, lo, hi, t: float,
                    method: str = "popcount", measure: str = "jaccard"):
    """Shard-local candidate-free join -> (m, n) bool qualifying mask on
    the bitmaps' device.

    ``r_bm``/``s_bm`` are int32 tensors holding the uint32 words; sizes
    and windows are host arrays. ``kernel_onehot`` runs the one-hot
    product (K5); every other method the popcount join (K3): like the
    reference, ``popcount`` and ``onehot`` shards compute the dense
    popcount, which K3 computes exactly (``_popcount_qualify`` ∧ window).
    On the CPU the kernels' plain versions run.
    """
    from ..kernels import ops as kops  # deferred: kernels import core
    fn = kops.onehot_join if method == "kernel_onehot" else kops.bitmap_join
    return fn(r_bm, r_sz, s_bm, s_sz, lo, hi, t, measure=measure)


# ---------------------------------------------------------------------- #
# host map phase: routing + vectorized, bucket-padded shard blocks
# ---------------------------------------------------------------------- #
@dataclasses.dataclass
class ShardBlock:
    """One bucket of shards padded to a common (m_pad, n_pad).

    ``arrays`` stacks (r_bm, r_sz, s_bm, s_sz, lo, hi) host arrays along
    a leading shard axis of length ``len(shard_ids)``; ``r_ids``/``s_ids``
    map packed rows/columns back to original set ids (-1 = padding).
    """

    shard_ids: np.ndarray  # (K,) global shard indices in this bucket
    arrays: tuple          # (r_bm, r_sz, s_bm, s_sz, lo, hi), leading dim K
    r_ids: np.ndarray      # (K, m_pad) int64
    s_ids: np.ndarray      # (K, n_pad) int64

    @property
    def n_local(self) -> int:
        return len(self.shard_ids)

    @property
    def m_pad(self) -> int:
        return self.r_ids.shape[1]

    @property
    def n_pad(self) -> int:
        return self.s_ids.shape[1]

    def block_bytes(self) -> int:
        return int(self.arrays[0].nbytes + self.arrays[2].nbytes)

    def shard(self, lk: int, device) -> tuple:
        """Shard ``lk``'s operands for ``local_join_mask``: the bitmaps
        uploaded to ``device``, sizes and windows as host rows."""
        r_bm, r_sz, s_bm, s_sz, lo, hi = self.arrays
        return (_words(r_bm[lk], device), r_sz[lk], _words(s_bm[lk], device),
                s_sz[lk], lo[lk], hi[lk])


def _ceil_pow2(x: int) -> int:
    return 1 << (int(max(x, 1)) - 1).bit_length()


def _flatten_routes(rows_per_shard):
    """Per-shard row lists -> (rows, shard_of, pos_in_shard) flat arrays."""
    counts = np.asarray([len(g) for g in rows_per_shard], dtype=np.int64)
    rows = (np.concatenate([np.asarray(g, dtype=np.int64)
                            for g in rows_per_shard])
            if counts.sum() else np.zeros(0, np.int64))
    shard_of = np.repeat(np.arange(len(rows_per_shard), dtype=np.int64),
                         counts)
    starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
    pos = np.arange(len(rows), dtype=np.int64) - starts[shard_of]
    return rows, shard_of, pos, counts


def _pack_side(rows, shard_of, pos, local_of_shard, K, pad, all_bm, sizes,
               ids):
    """Gather/scatter one side's flat routed rows into stacked block arrays."""
    W = all_bm.shape[1]
    bm = np.zeros((K, pad, W), np.uint32)
    sz = np.zeros((K, pad), np.int32)
    out_ids = np.full((K, pad), -1, np.int64)
    sel = local_of_shard[shard_of] >= 0
    if sel.any():
        k = local_of_shard[shard_of[sel]]
        p = pos[sel]
        r = rows[sel]
        bm[k, p] = all_bm[r]
        sz[k, p] = sizes[r]
        out_ids[k, p] = ids[r]
    return bm, sz, out_ids


def shard_blocks(R: SetCollection, S: SetCollection, part: Partitioning,
                 t: float, pad: str = "global"):
    """Build the post-shuffle layout: stacked, padded per-shard arrays.

    Routing and the per-shard size windows follow ``part.measure``
    (Lemma 3.1 generalized — DESIGN.md §8).

    pad: 'global' — every shard padded to the global (m_max, n_max); one
         ``ShardBlock`` covering all shards.
         'bucket' — shards grouped by power-of-two (m, n) footprint; each
         bucket padded to its own bucket maxima, so a skewed shard only
         inflates its bucket (paper Eq. 2-3 skew pathology).

    Returns ``(blocks, stats)`` where blocks is a list of ``ShardBlock``.
    Packing is vectorized: per-shard S rows are ordered by one global
    lexsort (shard, size desc, id asc) and all bitmaps/sizes/ids land via
    single fancy-index scatters — no per-shard Python packing loop.
    """
    if pad not in ("global", "bucket"):
        raise ValueError(f"unknown pad mode {pad!r}")
    s_rows, r_rows, stats = route(R, S, part)
    n_shards = part.n_shards
    universe = max(R.universe, S.universe)
    W = max((universe + 31) // 32, 1)
    all_r_bm, all_s_bm = R.bitmaps(W), S.bitmaps(W)
    r_sizes, s_sizes = R.sizes(), S.sizes()

    sf, s_shard, s_pos, n_k = _flatten_routes(s_rows)
    rf, r_shard, r_pos, m_k = _flatten_routes(r_rows)
    # FVT root-ward invariant per shard: S rows by (size desc, id asc),
    # grouped by shard — one stable lexsort instead of per-shard sorts
    order = np.lexsort((S.ids[sf], -s_sizes[sf].astype(np.int64), s_shard))
    sf = sf[order]

    if pad == "bucket":
        keys = [(_ceil_pow2(int(m_k[k])), _ceil_pow2(int(n_k[k])))
                for k in range(n_shards)]
        buckets: dict[tuple[int, int], list[int]] = {}
        for k, key in enumerate(keys):
            buckets.setdefault(key, []).append(k)
        # the pow-2 key only groups; each bucket pads to its own maxima,
        # so bucketed padding never exceeds the global-max packing
        groups = [(ids := np.asarray(v, np.int64),
                   max(1, int(m_k[ids].max())), max(1, int(n_k[ids].max())))
                  for v in (buckets[key] for key in sorted(buckets))]
    else:
        groups = [(np.arange(n_shards, dtype=np.int64),
                   max(1, int(m_k.max(initial=1))),
                   max(1, int(n_k.max(initial=1))))]

    blocks: list[ShardBlock] = []
    alloc_rows = np.ones(n_shards, np.float64)
    for shard_ids, m_pad, n_pad in groups:
        alloc_rows[shard_ids] = m_pad + n_pad
        K = len(shard_ids)
        local = np.full(n_shards, -1, np.int64)
        local[shard_ids] = np.arange(K)
        s_bm, s_sz, s_ids = _pack_side(sf, s_shard, s_pos, local, K, n_pad,
                                       all_s_bm, s_sizes, S.ids)
        r_bm, r_sz, r_ids = _pack_side(rf, r_shard, r_pos, local, K, m_pad,
                                       all_r_bm, r_sizes, R.ids)
        lo = np.zeros((K, m_pad), np.int32)
        hi = np.zeros((K, m_pad), np.int32)
        for lk, k in enumerate(shard_ids):
            mk, nk = int(m_k[k]), int(n_k[k])
            if mk and nk:
                l, h = window_bounds(r_sz[lk, :mk], s_sz[lk, :nk], t,
                                     part.measure)
                lo[lk, :mk] = l
                hi[lk, :mk] = h
        blocks.append(ShardBlock(shard_ids, (r_bm, r_sz, s_bm, s_sz, lo, hi),
                                 r_ids, s_ids))

    # packing stats: exact bytes + per-shard padding waste (fraction of
    # allocated bitmap rows that are padding)
    used_rows = (m_k + n_k).astype(np.float64)
    waste = 1.0 - used_rows / np.maximum(alloc_rows, 1.0)
    stats["shard_block_bytes"] = sum(b.block_bytes() for b in blocks)
    stats["shard_block_bytes_per_shard"] = (
        stats["shard_block_bytes"] / max(n_shards, 1))
    stats["pad_waste_max"] = float(waste.max(initial=0.0))
    stats["pad_waste_mean"] = float(waste.mean()) if n_shards else 0.0
    stats["pad"] = pad
    stats["n_buckets"] = len(blocks)
    return blocks, stats


# ---------------------------------------------------------------------- #
# reduce phase — dense masks (emit='mask')
# ---------------------------------------------------------------------- #
def _loop_reduce(block: ShardBlock, *, t: float, method: str, measure: str,
                 device) -> np.ndarray:
    """Every shard of ``block`` in turn -> the stacked (K, m_pad, n_pad)
    host masks."""
    return np.stack([
        local_join_mask(*block.shard(lk, device), t, method,
                        measure).cpu().numpy()
        for lk in range(block.n_local)])


def _shard_map_reduce(block: ShardBlock, mesh, *, t: float, method: str,
                      measure: str) -> np.ndarray:
    """The stacked-bitmap mesh reduce: shard ``lk`` of ``block`` on
    ``mesh.devices[lk]``, every shard launched before any mask comes back
    -> the stacked (K, m_pad, n_pad) host masks."""
    fault_point("device_upload")
    devices = mesh.devices[:block.n_local]
    placed = [block.shard(lk, dev) for lk, dev in enumerate(devices)]
    fault_point("shard_map")
    masks = []
    for args, dev in zip(placed, devices):
        with _on(dev):
            masks.append(local_join_mask(*args, t, method, measure))
    return np.stack(_host(masks))


# ---------------------------------------------------------------------- #
# reduce phase — shard-sparse (emit='pairs'): each shard's mask is
# compacted on the device; only (cap, 2) buffers + counts stay there
# ---------------------------------------------------------------------- #
def _shard_pairs_body(mask: torch.Tensor, cap: int):
    """In-shard compaction: (m, n) bool mask -> ((cap, 2) int32 pairs,
    exact int32 count). The count is exact even when the compaction
    truncates at ``cap`` — the regrow protocol depends on that."""
    return _compact_mask(mask, size=cap), _mask_total(mask)


def _reduce_pairs(shards, devices, *, t: float, method: str, cap: int,
                  measure: str, masks=None):
    """Every shard on its device -> (per-shard (cap, 2) int32 device pair
    buffers, (K,) host counts). All shards are launched before the counts
    are read, once per device. Without ``masks`` each shard's join runs
    here and its dense mask lives only until its compaction (on the loop
    path every device is the one device, so one mask exists at a time);
    with them (the mesh path's masks, kept across a regrow) only the
    compaction runs."""
    out = []
    for k, (args, dev) in enumerate(zip(shards, devices)):
        with _on(dev):
            mask = (masks[k] if masks is not None
                    else local_join_mask(*args, t, method, measure))
            out.append(_shard_pairs_body(mask, cap))
    return [p for p, _ in out], np.asarray(_host([c for _, c in out]))


def _block_pairs_reduce(block: ShardBlock, *, t: float, method: str,
                        cap_hint: int, measure: str, device, mesh=None):
    """Run the shard-sparse reduce for one bucket with the power-of-two
    regrow protocol: per-shard counts are exact, so an overflow regrows the
    capacity in one step and reruns at most once. With ``mesh`` shard
    ``lk`` runs on ``mesh.devices[lk]``, else every shard on ``device``.

    On the mesh, as on the mesh lfvt path, the shards upload once and
    their masks are kept: a regrow reruns the compaction only.

    Returns (per-shard (cap, 2) device pair buffers, counts (K,) np, cap,
    regrows); the caller transfers only each shard's ``[:count]`` slice.
    """
    cap = round_capacity(max(cap_hint, 1))
    regrows = 0
    fault_point("device_upload")
    devices = (mesh.devices[:block.n_local] if mesh is not None
               else (device,) * block.n_local)
    # upload once; a regrow rerun reuses the placement
    placed = [block.shard(lk, dev) for lk, dev in enumerate(devices)]
    masks = None
    while True:
        fault_point("compact")
        if mesh is not None:
            fault_point("shard_map")
            if masks is None:
                masks = []
                for args, dev in zip(placed, devices):
                    with _on(dev):
                        masks.append(local_join_mask(*args, t, method,
                                                     measure))
        pairs_dev, counts = _reduce_pairs(placed, devices, t=t,
                                          method=method, cap=cap,
                                          measure=measure, masks=masks)
        mx = int(counts.max(initial=0))
        if mx <= cap:
            return pairs_dev, counts, cap, regrows
        fault_point("regrow")
        cap = round_capacity(mx)
        regrows += 1


def _kernel_block_pairs(block: ShardBlock, *, t: float, method: str,
                        cap_hint: int | None, measure: str, device):
    """Per-shard live-tiled kernel reduce (loop path, kernel methods).

    Reuses the §6 live-tile schedule shard by shard (K2 for
    ``kernel_bitmap``, K4 for ``kernel_onehot``): each shard's qualifying
    mask is computed tile by tile with skipped tiles costing nothing, and
    compacted on the device into its own pair buffer. Shards stream
    double-buffered (shard k+1 dispatched before shard k's count syncs)
    so at most two shards' staged tile masks are resident.
    Returns (list of (n_k, 2) np pair arrays, counts, output_bytes,
    regrows, live_tiles, total_tiles, staged_mask_peak_bytes).
    """
    from ..kernels import ops as kops  # deferred: kernels import core
    dispatch = (kops.bitmap_join_pairs_dispatch if method == "kernel_bitmap"
                else kops.onehot_join_pairs_dispatch)
    per_shard, counts = [], []
    acc = {"out_bytes": 0, "regrows": 0, "live": 0, "total": 0}

    def settle(pending):
        kstats: dict = {}
        pp, n = kops.join_pairs_finalize(pending, capacity=cap_hint,
                                         stats=kstats)
        per_shard.append(pp[:n].cpu().numpy())  # device slice: ship n rows
        counts.append(n)
        acc["out_bytes"] += 8 * n + 4 + kstats.get("counts_bytes", 0)
        acc["regrows"] += kstats.get("regrows", 0)
        acc["live"] += kstats.get("live_tiles", 0)
        acc["total"] += kstats.get("total_tiles", 0)

    in_flight = None
    staged_sizes = []  # per-shard (L, TM, TN) staged live-tile mask bytes
    for lk in range(block.n_local):
        cur = dispatch(*block.shard(lk, device), t, measure=measure)
        staged_sizes.append(cur.live_tiles * cur.tm * cur.tn)
        if in_flight is not None:
            settle(in_flight)
        in_flight = cur
    if in_flight is not None:
        settle(in_flight)
    # double-buffering keeps at most two consecutive shards' staged masks
    # resident at once
    staged_peak = max(
        (staged_sizes[i] + (staged_sizes[i + 1] if i + 1 < len(staged_sizes)
                            else 0) for i in range(len(staged_sizes))),
        default=0)
    return (per_shard, np.asarray(counts), acc["out_bytes"], acc["regrows"],
            acc["live"], acc["total"], staged_peak)


# ---------------------------------------------------------------------- #
# reduce phase — flat-LFVT loop path (method='lfvt', DESIGN.md §9)
# ---------------------------------------------------------------------- #
_PEAK_KEYS = ("peak_mask", "peak_inter", "walk_vmem", "waste_max")


def _fold_delta(acc: dict, delta: dict) -> None:
    """Fold a resilience task's stat deltas into a driver accumulator:
    peaks combine by max, counters by sum, non-numeric keys (the rung
    name) are dropped."""
    for k, v in delta.items():
        if k in acc and isinstance(v, (int, float)) \
                and not isinstance(v, bool):
            acc[k] = max(acc[k], v) if k in _PEAK_KEYS else acc[k] + v


def _sub_collection(C: SetCollection, rows) -> SetCollection:
    """Row-subset collection keeping global ids (oracle-rung input)."""
    return SetCollection([C.sets[int(i)] for i in rows], C.universe,
                         C.ids[rows].astype(np.int32))


def _guardrail_spans(rows, n_cols: int, res, device) -> list:
    """Pre-dispatch memory guardrail: split a shard's R rows so the
    estimated dense (|rows|, n_cols) int32 working set fits the budget
    for ``device`` (``resolve_guardrail_budget``). Active only on the
    resilience path."""
    if res is None or not global_config.memory_guardrail or not len(rows):
        return [rows]
    est = len(rows) * n_cols * 4
    budget = resolve_guardrail_budget(device)
    if est <= budget:
        return [rows]
    chunks = min(len(rows), -(-est // budget))
    spans = [c for c in np.array_split(np.asarray(rows), chunks) if len(c)]
    res.guardrail_splits += len(spans) - 1
    return spans


def _lfvt_loop_join(R: SetCollection, S: SetCollection, t: float, part,
                    *, emit: str, pair_capacity: int | None, measure: str,
                    stats: dict | None, device, impl: str = "kernel",
                    res=None, shard_methods=None) -> set:
    """Per-shard flat-LFVT reduce on the sequential loop path.

    The map side routes rows exactly like the bitmap paths, but each
    shard's S partition is compiled to a ``FlatLFVT`` on the host —
    nothing |S|·W-shaped is ever materialized — and its R rows are
    uploaded as a -1-padded block. Shards stream double-buffered: shard
    k+1's walk is dispatched before shard k's pair count syncs.
    ``impl='kernel'`` (method='lfvt') runs each shard's reduce (both emit
    modes) through the live row-tiled walk (K1) and mirrors its
    walk_steps/early_stops/live_tiles stats; ``impl='ref'``
    (method='lfvt_ref') the whole-block walk.

    ``shard_methods`` (method='auto', heterogeneous dispatch) overrides
    the rep family per shard: 'popcount' shards take the dense bitmap
    reduce (K3), 'lfvt'/'lfvt_ref' shards the flat-LFVT walk above —
    mixed freely, since the loop path never stacks shard shapes.
    """
    from ..kernels import ops as kops  # deferred: kernels import core

    s_rows, r_rows, route_stats = route(R, S, part)
    r_sizes = R.sizes()
    s_sizes_all = S.sizes()
    r_pad_all, _ = R.padded()
    W = max((max(R.universe, S.universe) + 31) // 32, 1)
    pairs: set = set()

    def _impl_of(kind: str | None) -> str:
        if kind is None:
            return impl
        return {"popcount": "popcount", "lfvt": "kernel",
                "lfvt_ref": "ref"}[kind]

    kinds = (list(shard_methods) if shard_methods is not None
             else [None] * part.n_shards)

    def zero_acc() -> dict:
        return {"reduce": 0, "result": 0, "regrows": 0, "dense": 0,
                "peak_mask": 0, "peak_inter": 0, "ship": 0, "shards": 0,
                "walk_steps": 0, "early_stops": 0, "live": 0, "total": 0,
                "walk_vmem": 0}

    acc = zero_acc()
    # shard -> its S as a FlatLFVT: encoded once per call, so the spans of
    # a guardrail-split shard (and a retried rung) walk one table
    flats: dict = {}

    def dispatch(k: int, rs, ss, acc: dict, use_impl: str) -> dict | None:
        if not len(rs) or not len(ss):
            return None
        if use_impl == "popcount":
            # planner-picked light shard: dense bitmap popcount reduce.
            # Columns are sorted size-descending (ties by id) so
            # ``window_bounds`` applies exactly like the tile driver.
            order = np.lexsort((S.ids[ss], -s_sizes_all[ss]))
            ss = np.asarray(ss)[order]
            s_bm, s_sz = S.bitmaps(W)[ss], s_sizes_all[ss]
            r_bm, sz = R.bitmaps(W)[rs], r_sizes[rs]
            lo, hi = window_bounds(sz, s_sz, t, measure)
            acc["ship"] += (s_bm.nbytes + s_sz.nbytes + r_bm.nbytes
                            + sz.nbytes)
            acc["dense"] += len(rs) * len(ss)
            acc["shards"] += 1
            mask = local_join_mask(
                _words(r_bm, device), sz, _words(s_bm, device), s_sz, lo,
                hi, t, method="popcount", measure=measure)
            return {"rs": rs, "mask": mask, "sids": S.ids[ss]}
        if k not in flats:
            flats[k] = SetCollection(
                [S.sets[int(j)] for j in ss], S.universe,
                S.ids[ss].astype(np.int32)).flat_lfvt()
        flat = checked_flat(flats[k])
        r_pad, sz = r_pad_all[rs], r_sizes[rs]
        lo, hi = window_bounds(sz, flat.s_sizes, t, measure)
        # map-output bytes: the serialized flat arrays + the shard's R rows
        acc["ship"] += flat.nbytes() + r_pad.nbytes + sz.nbytes
        acc["dense"] += len(rs) * len(ss)
        acc["shards"] += 1
        # both emit modes share the same dispatch (the walk kernel for
        # 'lfvt', the whole-block walk for 'lfvt_ref'); emit='mask' is
        # resolved by ``join_mask_finalize`` instead of compaction
        walk = (kops.lfvt_join_pairs_dispatch if use_impl == "ref"
                else kops.lfvt_walk_join_pairs_dispatch)
        pending = walk(flat, upload(r_pad, device), sz, lo, hi, t,
                       measure=measure)
        return {"rs": rs, "flat": flat, "pending": pending}

    def finalize(ctx: dict, acc: dict, out_pairs: set) -> None:
        if "mask" in ctx:  # popcount shard (planner heterogeneous path)
            rs, mask = ctx["rs"], ctx["mask"]
            # compacted on the device: the dense mask never leaves it
            rr, cc = (x.cpu().numpy() for x in torch.nonzero(
                mask, as_tuple=True))
            if emit == "pairs":
                acc["reduce"] += 8 * len(rr) + 4
                acc["result"] += len(rr)
            else:
                acc["reduce"] += mask.numel()
            acc["peak_mask"] = max(acc["peak_mask"], mask.numel())
            acc["peak_inter"] = max(acc["peak_inter"],
                                    mask.numel() + 8 * len(rr))
            if len(rr):
                rid = R.ids[rs[rr]]
                sid = ctx["sids"][cc]
                out_pairs.update(zip(map(int, rid), map(int, sid)))
            return
        rs, flat = ctx["rs"], ctx["flat"]
        kstats: dict = {}
        if emit == "pairs":
            pp, nk = kops.join_pairs_finalize(
                ctx["pending"], capacity=pair_capacity, stats=kstats)
            local = pp[:nk].cpu().numpy()
            acc["reduce"] += 8 * nk + 4 + kstats.get("counts_bytes", 0)
            acc["regrows"] += kstats.get("regrows", 0)
            acc["result"] += nk
            mask_cells = len(rs) * flat.n_sets
            acc["peak_mask"] = max(acc["peak_mask"], mask_cells)
            acc["peak_inter"] = max(
                acc["peak_inter"], mask_cells + kstats.get("pair_bytes", 0))
        else:
            mask = kops.join_mask_finalize(
                ctx["pending"], len(rs), flat.n_sets, kstats)
            local = np.argwhere(mask)
            acc["reduce"] += mask.size
            acc["peak_mask"] = max(acc["peak_mask"], mask.size)
            acc["peak_inter"] = max(acc["peak_inter"], mask.size)
        acc["walk_steps"] += kstats.get("walk_steps", 0)
        acc["early_stops"] += kstats.get("early_stops", 0)
        acc["live"] += kstats.get("live_tiles", 0)
        acc["total"] += kstats.get("total_tiles", 0)
        acc["walk_vmem"] = max(acc["walk_vmem"],
                               kstats.get("walk_vmem_tile_bytes", 0))
        if len(local):
            rid = R.ids[rs[local[:, 0]]]
            sid = flat.s_ids[local[:, 1]]
            out_pairs.update(zip(map(int, rid), map(int, sid)))

    if res is None:
        in_flight: dict | None = None
        for k in range(part.n_shards):
            ctx = dispatch(k, r_rows[k], s_rows[k], acc, _impl_of(kinds[k]))
            flats.pop(k, None)  # the in-flight context holds its table
            if in_flight is not None:
                finalize(in_flight, acc, pairs)
                in_flight = None
            if ctx is not None:
                in_flight = ctx
        if in_flight is not None:
            finalize(in_flight, acc, pairs)
    else:
        # resilience ladder per shard (DESIGN.md §12): the kernel walk
        # degrades to the whole-block walk, then to the host oracle;
        # oversized shards are guardrail-split before dispatch
        from .join import brute_force_join  # deferred: the oracle rung

        def run_impl(use_impl: str, k: int, rs, ss):
            sub_acc, sub_pairs = zero_acc(), set()
            ctx = dispatch(k, rs, ss, sub_acc, use_impl)
            if ctx is not None:
                finalize(ctx, sub_acc, sub_pairs)
            return sorted_pairs(sub_pairs), sub_acc

        def oracle(rs, ss):
            got = brute_force_join(_sub_collection(R, rs),
                                   _sub_collection(S, ss), t,
                                   measure=measure)
            sub_acc = zero_acc()
            sub_acc["shards"] += 1
            if emit == "pairs":
                sub_acc["result"] = len(got)
            return sorted_pairs(got), sub_acc

        for k in range(part.n_shards):
            rs, ss = r_rows[k], s_rows[k]
            if not len(rs) or not len(ss):
                continue
            use = _impl_of(kinds[k])
            spans = _guardrail_spans(rs, len(ss), res, device)
            for si, sub_rs in enumerate(spans):
                if kinds[k] is not None:
                    tid = f"auto_loop/{kinds[k]}/{emit}/{measure}/shard={k}"
                else:
                    tid = f"lfvt_loop/{impl}/{emit}/{measure}/shard={k}"
                if len(spans) > 1:
                    tid += f"/span={si}"
                if use == "popcount":
                    rungs = [("popcount",
                              functools.partial(run_impl, "popcount", k,
                                                sub_rs, ss))]
                else:
                    rungs = [("lfvt" if use == "kernel" else "lfvt_ref",
                              functools.partial(run_impl, use, k, sub_rs,
                                                ss))]
                    if use == "kernel":
                        rungs.append(("lfvt_ref",
                                      functools.partial(run_impl, "ref", k,
                                                        sub_rs, ss)))
                rungs.append(("oracle",
                              functools.partial(oracle, sub_rs, ss)))
                got, delta = res.run(tid, rungs)
                pairs.update((int(a), int(b)) for a, b in got)
                _fold_delta(acc, delta)
            flats.pop(k, None)

    n_result = acc["result"] if emit == "pairs" else len(pairs)
    if stats is not None:
        stats.update(route_stats)
        stats.update(
            intervals=part.intervals, psi=part.psi, n_shards=part.n_shards,
            emit=emit, measure=measure, result_pairs=n_result,
            pair_bytes=n_result * 8, reduce_bytes=acc["reduce"],
            dense_mask_bytes=acc["dense"],
            reduce_intermediate_peak_bytes=acc["peak_inter"],
            reduce_mask_peak_bytes=acc["peak_mask"],
            walk_steps=acc["walk_steps"], early_stops=acc["early_stops"],
            live_tiles=acc["live"], total_tiles=acc["total"],
            walk_vmem_tile_bytes=acc["walk_vmem"],
            regrows=acc["regrows"], pad="ragged", n_buckets=acc["shards"],
            shard_block_bytes=acc["ship"],
            shard_block_bytes_per_shard=acc["ship"] / max(part.n_shards, 1),
            pad_waste_max=0.0, pad_waste_mean=0.0)
        resilience_stats(stats, res)
    return pairs


# ---------------------------------------------------------------------- #
# reduce phase — mesh flat-LFVT path (method='lfvt' with a mesh,
# DESIGN.md §11): bucketed pow-2 sentinel padding makes the per-shard
# flat tables rectangular, so a bucket stacks them
# ---------------------------------------------------------------------- #
def _lfvt_local_mask(entry_elem, entry_pos, entry_len, seq, nxt, s_sizes,
                     r_padded, r_sizes, lo, hi, *, t: float, measure: str,
                     max_steps: int, tm: int, schedule: str = "planned"):
    """One shard's flat-LFVT walk + qualify, on its operands' device.

    The shard-local compute of the mesh path, the reference's traced
    shard body: a sparse entry lookup (binary search over the sorted
    entry table; entry rows arrive resolved to absolute walk positions,
    ``lfvt_flat.entry_positions``, so the node table never ships), the
    lanes of each row ordered by remaining walk length (descending,
    stable, as ``jnp.argsort``), then the row-tiled walk. Under
    ``schedule='planned'`` (the default) the live-tile plan is made on
    the device (``plan_row_tiles_device``: the host planner's exact
    ``any(lo < hi)`` criterion, live ids first) and the planned walk
    (K6) walks only the live tiles — fully-dead row tiles (bucket pad
    rows, window-dead R rows) cost no walk steps, and nothing waits for
    the device. ``schedule='static'`` walks every tile with K1. Masks
    are bit-identical across schedules. Sentinel rows (padded
    entries/seq/sets) are unreachable: pad entries have ``entry_len`` 0,
    no real hop chain points past the original T, and padded S columns
    have size 0 — outside every window and failing the f > 0 predicate.
    K6 zeroes dead tiles' mask rows in 16-byte stores, so the S side is
    padded to whole 16 columns the same way and the mask sliced back.

    Returns (mask (mp, n) bool, walk_steps, early_stops, live_tiles —
    0-d int32 tensors on the device; the counters are per-tile sums, as
    the kernels count them; under 'static' live_tiles is the full tile
    count, every tile having been walked).
    """
    from ..kernels import lfvt_walk as _lw  # deferred: kernels import core

    mp = r_padded.shape[0]
    n = s_sizes.shape[0]
    E = entry_elem.shape[0]
    idx = torch.clamp(torch.searchsorted(entry_elem, r_padded), max=E - 1)
    present = (r_padded >= 0) & (entry_elem[idx] == r_padded)
    zero = torch.zeros((), dtype=torch.int32, device=r_padded.device)
    pos = torch.where(present, entry_pos[idx], zero)
    rem = torch.where(present, entry_len[idx], zero)
    order = torch.argsort(-rem, dim=1, stable=True)
    lane_pos = torch.gather(pos, 1, order).contiguous()
    lane_rem = torch.gather(rem, 1, order).contiguous()
    lo32, hi32 = lo.reshape(-1, 1), hi.reshape(-1, 1)
    ssz = torch.nn.functional.pad(s_sizes, (0, -n % 16)).reshape(1, -1)
    operands = (lane_pos, lane_rem, nxt.reshape(1, -1), seq.reshape(1, -1),
                ssz, r_sizes.reshape(-1, 1), lo32, hi32)
    kw = dict(t=t, measure=measure, max_steps=max_steps, tm=tm)
    if schedule == "planned":
        ti_sorted, live = _lw.plan_row_tiles_device(lo32, hi32, tm)
        masks, _, steps, stops = _lw.lfvt_walk_planned(ti_sorted, live,
                                                      *operands, **kw)
    else:
        ti = torch.arange(mp // tm, dtype=torch.int32,
                          device=r_padded.device)
        masks, _, steps, stops = _lw.lfvt_walk_live_tiled(ti, *operands,
                                                          **kw)
        live = torch.full((), mp // tm, dtype=torch.int32,
                          device=r_padded.device)
    return (masks.reshape(mp, -1)[:, :n], steps.sum(dtype=torch.int32),
            stops.sum(dtype=torch.int32), live)


def _lfvt_bucket_arrays(bucket, caps, Lr, r_pad_all, r_sizes_all, R_ids,
                        t: float, measure: str):
    """Stack one bucket's shards into rectangular sentinel-padded arrays.

    ``bucket`` is [(shard_id, FlatLFVT, r_row_indices, max|r|)]; ``caps``
    the bucket maxima (mp, np_, Ep, Tp, max_steps) and ``Lr`` the bucket
    lane width (max|r| over the bucket — R rows are sliced to it, which
    only drops -1 pad columns). Returns (host operand tuple, r_ids
    (K, mp), s_ids (K, np_), used/alloc int32 cell counts per shard for
    the pad-waste stats).
    """
    from .lfvt_flat import PAD_SENTINEL, entry_positions, pad_flat_tables

    mp, np_, Ep, Tp, _ = caps
    K = len(bucket)
    ee = np.full((K, Ep), PAD_SENTINEL, np.int32)
    epos = np.zeros((K, Ep), np.int32)
    elen = np.zeros((K, Ep), np.int32)
    seq = np.zeros((K, Tp), np.int32)
    nxt = np.full((K, Tp), -1, np.int32)
    ssz = np.zeros((K, np_), np.int32)
    s_ids = np.full((K, np_), -1, np.int64)
    rpad = np.full((K, mp, Lr), -1, np.int32)
    rsz = np.zeros((K, mp), np.int32)
    lo = np.zeros((K, mp), np.int32)
    hi = np.zeros((K, mp), np.int32)
    r_ids = np.full((K, mp), -1, np.int64)
    used = np.zeros(K, np.float64)
    for lk, (_, flat, rs, lr_k) in enumerate(bucket):
        mk, nk = len(rs), flat.n_sets
        Ek, Tk = len(flat.entry_elem), len(flat.seq_row)
        padded = pad_flat_tables(flat, n_entries=Ep, n_seq=Tp, n_sets=np_)
        ee[lk] = padded.entry_elem
        epos[lk] = entry_positions(padded)
        elen[lk] = padded.entry_len
        seq[lk] = padded.seq_row
        nxt[lk] = padded.seq_next
        ssz[lk] = padded.s_sizes
        s_ids[lk] = padded.s_ids
        rpad[lk, :mk] = r_pad_all[rs][:, :Lr]
        rsz[lk, :mk] = r_sizes_all[rs]
        l, h = window_bounds(r_sizes_all[rs], flat.s_sizes, t, measure)
        lo[lk, :mk] = l
        hi[lk, :mk] = h
        r_ids[lk, :mk] = R_ids[rs]
        # shipped walk-table cells: R side mk·(max|r|+3) [elements +
        # size/lo/hi at the shard's own lane width], S side 3·E + 2·T
        # + n [entry triplet + seq/hop + set sizes]
        used[lk] = mk * (lr_k + 3) + 3 * Ek + 2 * Tk + nk
    alloc = float(mp * (Lr + 3) + 3 * Ep + 2 * Tp + np_)
    arrays = (ee, epos, elen, seq, nxt, ssz, rpad, rsz, lo, hi)
    return arrays, r_ids, s_ids, used, alloc


def _lfvt_mesh_join(R: SetCollection, S: SetCollection, t: float, part,
                    mesh, *, emit: str, pad: str,
                    pair_capacity: int | None, measure: str,
                    stats: dict | None, device, res=None,
                    schedule: str | None = None) -> set:
    """MR-CF-RS-Join/LFVT on the mesh: the paper's headline method as
    the reference runs it (DESIGN.md §11).

    Map phase (host): route rows, compile each shard's S partition to a
    ``FlatLFVT``, resolve entries to absolute walk positions, then group
    shards into pow-2 footprint buckets (the ``ShardBlock`` bucketing
    extended to the flat node/seq/entry tables) and sentinel-pad each
    bucket to its own maxima, with pad waste reported like the packing
    stats.

    Reduce phase (device): per bucket, shard ``lk`` on the mesh's slot
    ``lk``; each runs the flat-array walk (``_lfvt_local_mask``) and —
    for emit='pairs' — the in-shard fixed-cap compaction with the
    power-of-two regrow protocol (upload once, rerun the compaction
    only on overflow). Only the count's rows of each pair buffer, the
    counts and the walk counters leave a shard.

    ``schedule``: 'planned' (the default) plans the live row tiles on the device and walks them with K6;
    'static' walks every tile with K1. Results are bit-identical.

    With ``res`` each bucket is a task of the ladder mesh -> loop (the
    whole-block walk, shard by shard on ``device``) -> host oracle; a
    bucket whose dense masks would pass the guardrail's budget
    (``resolve_guardrail_budget``) starts at the loop rung.
    """
    from ..kernels import lfvt_walk as _lw  # deferred: kernels import core

    schedule = schedule or "planned"
    s_rows, r_rows, route_stats = route(R, S, part)
    r_sizes_all = R.sizes()
    r_pad_all, _ = R.padded()
    Lr = r_pad_all.shape[1] if r_pad_all.ndim == 2 else 0
    n_devices = len(mesh.devices)

    shards = []
    for k in range(part.n_shards):
        rs, ss = r_rows[k], s_rows[k]
        if not len(rs) or not len(ss):
            continue
        # size-sort each shard's R rows (stable, descending — the loop
        # dispatch's order): rows with near-identical Lemma-3.1 windows
        # share a row tile, so window-dead rows cluster into fully-dead
        # tiles the planned schedule skips; pairs are id-mapped, so the
        # row order never changes results
        rs = rs[np.argsort(-r_sizes_all[rs], kind="stable")]
        sub = SetCollection([S.sets[int(j)] for j in ss], S.universe,
                            S.ids[ss].astype(np.int32))
        shards.append((k, sub.flat_lfvt(), rs))

    # pow-2 bucketing over the flat-table footprint axes (m, n, E, T)
    # plus the shard-local R lane width max|r|; the key only groups, each
    # bucket pads to its own per-axis maxima, so bucketed padding never
    # exceeds the global-max packing. pad='global' keeps one all-shards
    # bucket at the cost of global-cap padding.
    buckets: dict[tuple, list] = {}
    for k, flat, rs in shards:
        lr_k = max(int(r_sizes_all[rs].max(initial=0)), 1)
        key = (1,) if pad == "global" else (
            _ceil_pow2(len(rs)), _ceil_pow2(flat.n_sets),
            _ceil_pow2(max(len(flat.entry_elem), 1)),
            _ceil_pow2(max(len(flat.seq_row), 1)), _ceil_pow2(lr_k))
        buckets.setdefault(key, []).append((k, flat, rs, lr_k))

    pairs: set = set()

    def zero_acc() -> dict:
        return {"reduce": 0, "result": 0, "regrows": 0, "dense": 0,
                "peak_mask": 0, "peak_inter": 0, "ship": 0,
                "walk_steps": 0, "early_stops": 0, "walk_vmem": 0,
                "live": 0, "total": 0,
                "waste_sum": 0.0, "waste_max": 0.0, "waste_n": 0}

    acc = zero_acc()
    cap_hint = pair_capacity if pair_capacity else global_config.pair_cap_grain
    tm = global_config.row_tile

    def run_bucket(bucket, caps, lr_b, acc: dict, out_pairs: set) -> None:
        """One bucket's pack + walk + emit (the mesh rung body)."""
        K = len(bucket)
        for _, flat, _, _ in bucket:
            checked_flat(flat)  # injected-corruption detection site
        arrays, r_ids, s_ids, used, alloc = _lfvt_bucket_arrays(
            bucket, caps, lr_b, r_pad_all, r_sizes_all, R.ids, t, measure)
        w = 1.0 - used / alloc
        acc["waste_sum"] += float(w.sum())
        acc["waste_max"] = max(acc["waste_max"], float(w.max(initial=0.0)))
        acc["waste_n"] += len(w)
        acc["ship"] += 4 * K * int(alloc)
        mp, np_ = caps[0], caps[1]
        acc["dense"] += K * mp * np_
        devices = mesh.devices[:K]  # shard lk of the bucket on slot lk
        fault_point("device_upload")
        placed = _place(arrays, devices)
        fault_point("shard_map")
        masks, counters = [], []
        for args, dev in zip(placed, devices):
            with _on(dev):
                mask, *ctr = _lfvt_local_mask(
                    *args, t=t, measure=measure, max_steps=caps[4], tm=tm,
                    schedule=schedule)
            masks.append(mask)
            counters.append(torch.stack(ctr))
        if emit == "pairs":
            cap = round_capacity(max(cap_hint, 1))
            while True:  # regrow: exact counts, compaction-only rerun
                fault_point("compact")
                packed = []
                for mask, dev in zip(masks, devices):
                    with _on(dev):
                        packed.append(_shard_pairs_body(mask, cap))
                got = _host([c for _, c in packed] + counters)
                counts = np.asarray(got[:K])
                mx = int(counts.max(initial=0))
                if mx <= cap:
                    break
                fault_point("regrow")
                cap = round_capacity(mx)
                acc["regrows"] += 1
            for lk in range(K):
                c = int(counts[lk])
                if c:
                    local = packed[lk][0][:c].cpu().numpy()
                    rid = r_ids[lk, local[:, 0]]
                    sid = s_ids[lk, local[:, 1]]
                    keep = (rid >= 0) & (sid >= 0)
                    out_pairs.update(zip(map(int, rid[keep]),
                                         map(int, sid[keep])))
            acc["reduce"] += int(counts.sum()) * 8 + K * 4
            acc["result"] += int(counts.sum())
            acc["peak_mask"] = max(acc["peak_mask"], mp * np_)
            acc["peak_inter"] = max(acc["peak_inter"],
                                    mp * np_ + K * (cap * 8 + 4))
        else:
            got = _host(masks + counters)
            # per-shard mask cells (mk x n_k real rows/cols, the loop
            # path's truth) — the stacked (K, mp, np_) transfer includes
            # sentinel padding, which is an artifact of the bucket
            # rectangle, not reduce output
            cells = ((r_ids >= 0).sum(axis=1).astype(np.int64)
                     * (s_ids >= 0).sum(axis=1))
            for lk in range(K):
                rr, cc = np.nonzero(got[lk])
                out_pairs.update(
                    (int(r_ids[lk, i]), int(s_ids[lk, j]))
                    for i, j in zip(rr, cc)
                    if r_ids[lk, i] >= 0 and s_ids[lk, j] >= 0)
            acc["reduce"] += int(cells.sum())
            acc["peak_mask"] = max(acc["peak_mask"],
                                   int(cells.max(initial=0)))
            acc["peak_inter"] = max(acc["peak_inter"],
                                    int(cells.max(initial=0)))
        ctr = np.stack(got[K:])
        acc["walk_steps"] += int(ctr[:, 0].sum())
        acc["early_stops"] += int(ctr[:, 1].sum())
        acc["live"] += int(ctr[:, 2].sum())
        acc["total"] += K * (mp // tm)
        # the per-tile working set of this bucket's layout, by the
        # reference's accounting
        acc["walk_vmem"] = max(
            acc["walk_vmem"],
            _lw.walk_vmem_tile_bytes(tm, lr_b, np_, caps[3]))

    for key in sorted(buckets):
        bucket = buckets[key]
        K = len(bucket)
        # mp rounds up to the row-tile multiple: the shard-local walk is
        # row-tiled, and the extra rows are -1-padded with lo = hi = 0
        # (dead lanes — under the planned schedule whole pad tiles are
        # skipped by the device live-tile plan); lane width slices to
        # the bucket max|r| (columns past a row's own size are -1 pads,
        # so slicing drops only dead lanes)
        caps = (-(-max(len(rs) for _, _, rs, _ in bucket) // tm) * tm,
                max(f.n_sets for _, f, _, _ in bucket),
                max(max(len(f.entry_elem), 1) for _, f, _, _ in bucket),
                max(max(len(f.seq_row), 1) for _, f, _, _ in bucket),
                max(f.max_seq_len for _, f, _, _ in bucket))
        lr_b = min(max(lr for _, _, _, lr in bucket), Lr) if Lr else 1
        if res is None:
            run_bucket(bucket, caps, lr_b, acc, pairs)
            continue
        # resilience ladder per bucket (DESIGN.md §12): mesh -> per-shard
        # loop walk -> host oracle; an over-budget bucket skips straight
        # to the loop rung (memory guardrail)
        from ..kernels import ops as kops  # deferred: kernels import core
        from .join import brute_force_join  # deferred: the oracle rung
        tid = (f"lfvt_mesh/{emit}/{measure}/shards="
               + "-".join(str(k) for k, _, _, _ in bucket))

        def mesh_rung(bucket=bucket, caps=caps, lr_b=lr_b):
            sub_acc, sub_pairs = zero_acc(), set()
            run_bucket(bucket, caps, lr_b, sub_acc, sub_pairs)
            return sorted_pairs(sub_pairs), sub_acc

        def loop_rung(bucket=bucket):
            sub_acc, sub_pairs = zero_acc(), set()
            for _, flat, rs, _ in bucket:
                checked_flat(flat)
                sz = r_sizes_all[rs]
                lo, hi = window_bounds(sz, flat.s_sizes, t, measure)
                pp, nk = kops.join_pairs_finalize(
                    kops.lfvt_join_pairs_dispatch(
                        flat, upload(r_pad_all[rs], device), sz, lo, hi, t,
                        measure=measure), capacity=pair_capacity)
                local = pp[:nk].cpu().numpy()
                if len(local):
                    rid = R.ids[rs[local[:, 0]]]
                    sid = flat.s_ids[local[:, 1]]
                    sub_pairs.update(zip(map(int, rid), map(int, sid)))
                if emit == "pairs":
                    sub_acc["result"] += nk
                sub_acc["reduce"] += 8 * nk + 4
            return sorted_pairs(sub_pairs), sub_acc

        def oracle_rung(bucket=bucket):
            sub_acc, sub_pairs = zero_acc(), set()
            for _, flat, rs, _ in bucket:
                ss = np.nonzero(np.isin(
                    np.asarray(S.ids), np.asarray(flat.s_ids)))[0]
                got = brute_force_join(_sub_collection(R, rs),
                                       _sub_collection(S, ss), t,
                                       measure=measure)
                sub_pairs.update(got)
                if emit == "pairs":
                    sub_acc["result"] += len(got)
            return sorted_pairs(sub_pairs), sub_acc

        rungs = [("mesh", mesh_rung)]
        mp, np_ = caps[0], caps[1]
        if (global_config.memory_guardrail and K * mp * np_ * 4
                > resolve_guardrail_budget(mesh.devices[0])):
            res.degradations.append(f"{tid}:mesh->loop(guardrail)")
            rungs = []
        rungs += [("loop", loop_rung), ("oracle", oracle_rung)]
        got, delta = res.run(tid, rungs)
        pairs.update((int(a), int(b)) for a, b in got)
        _fold_delta(acc, delta)

    n_result = acc["result"] if emit == "pairs" else len(pairs)
    if stats is not None:
        stats.update(route_stats)
        stats.update(
            intervals=part.intervals, psi=part.psi, n_shards=part.n_shards,
            emit=emit, measure=measure, result_pairs=n_result,
            pair_bytes=n_result * 8, reduce_bytes=acc["reduce"],
            dense_mask_bytes=acc["dense"],
            reduce_intermediate_peak_bytes=acc["peak_inter"],
            reduce_mask_peak_bytes=acc["peak_mask"],
            walk_steps=acc["walk_steps"], early_stops=acc["early_stops"],
            # per-shard device-plan live counts summed across the mesh
            # ('static' reports every tile as walked)
            live_tiles=acc["live"], total_tiles=acc["total"],
            walk_schedule=schedule,
            walk_vmem_tile_bytes=acc["walk_vmem"],
            regrows=acc["regrows"], pad=pad, n_buckets=len(buckets),
            mesh_devices=n_devices,
            shard_block_bytes=acc["ship"],
            shard_block_bytes_per_shard=acc["ship"] / max(part.n_shards, 1),
            pad_waste_max=acc["waste_max"],
            pad_waste_mean=(acc["waste_sum"] / acc["waste_n"]
                            if acc["waste_n"] else 0.0),
            flat_pad_waste=(acc["waste_sum"] / acc["waste_n"]
                            if acc["waste_n"] else 0.0))
        resilience_stats(stats, res)
    return pairs


# ---------------------------------------------------------------------- #
# the driver
# ---------------------------------------------------------------------- #
def _emit_shard_pairs(block: ShardBlock, lk: int, local: np.ndarray,
                      out: set) -> None:
    """Map one shard's packed (row, col) indices back to original ids."""
    if not len(local):
        return
    rid = block.r_ids[lk, local[:, 0]]
    sid = block.s_ids[lk, local[:, 1]]
    keep = (rid >= 0) & (sid >= 0)  # belt: padding can't qualify
    out.update(zip(map(int, rid[keep]), map(int, sid[keep])))


def _collect_block_pairs(block: ShardBlock, pairs_dev,
                         counts: np.ndarray, out: set) -> None:
    """Transfer each shard's variable-length pair slice and map the packed
    (row, col) indices back to original ids.

    Only ``pairs_dev[k, :counts[k]]`` ever crosses the host boundary —
    the cap-sized buffer stays device-resident (reduce output bytes are
    ``8·n_k + 4`` per shard, the Fig. 8 model)."""
    for lk in range(len(counts)):
        c = int(counts[lk])
        if c:
            _emit_shard_pairs(block, lk, pairs_dev[lk][:c].cpu().numpy(),
                              out)


def mr_cf_rs_join(R: SetCollection, S: SetCollection, t: float,
                  n_shards: int, strategy: str = "load_aware",
                  method: str = "popcount", mesh=None,
                  axis: str | None = None, stats: dict | None = None,
                  emit: str = "pairs", pad: str | None = None,
                  pair_capacity: int | None = None,
                  measure: str = "jaccard", fault_plan=None,
                  checkpoint_dir: str | None = None,
                  schedule: str | None = None, plan=None,
                  device=None) -> set:
    """Distributed candidate-free R-S join. Returns {(r_id, s_id)}.

    strategy: 'load_aware' (paper Eq. 2-3) | 'hash' (ablation baseline:
              all of S on every shard, R split round-robin)
    method:   'auto' — the cost-model planner (core/planner.py,
              DESIGN.md §14) probes the routed inputs and picks per
              shard (light small-universe shards run the bitmap
              popcount, heavy shards the LFVT walk); decisions land in
              ``stats["plan"]``/``stats["shard_methods"]``. Or force one
              of 'popcount' | 'onehot' | 'kernel_bitmap' |
              'kernel_onehot' (shard-local tile joins over bitmap
              blocks) | 'lfvt' / 'lfvt_ref' — each shard's S partition
              is compiled to a ``FlatLFVT`` (DESIGN.md §9); nothing
              |S|·W-shaped is materialized. 'lfvt' reduces through the
              live row-tiled walk (K1) on the loop path and — with a mesh
              — through the bucketed sentinel-padded mesh path (K6, or K1
              under ``schedule='static'``); 'lfvt_ref' through the
              whole-block walk (loop path only).
    measure:  'jaccard' | 'cosine' | 'dice' | 'overlap' — qualify
              predicate, per-shard windows and map-phase R replication
              all specialize per measure (DESIGN.md §8)
    mesh:     a ``repro_torch.launch.mesh.Mesh``: the reduce runs shard
              ``k`` on slot ``k``'s device along ``axis`` (the mesh's
              axis by default; its size must equal ``n_shards``);
              otherwise a sequential shard loop.
              Anything else raises ``MeshTypeError``.
    emit:     'pairs' (default) — each shard's pairs are compacted on the
              device into a (cap, 2) buffer + exact count (regrown on
              overflow, power-of-two protocol); ``reduce_bytes`` counts
              the compacted slices (the paper's Fig. 8 model). 'mask' —
              every per-shard boolean mask comes back to the host.
    pad:      'auto' (bucket on the loop and mesh-lfvt paths, global for
              the stacked-bitmap mesh reduce) | 'global' | 'bucket' — see
              ``shard_blocks``; defaults to ``global_config.pad_mode``.
    pair_capacity: initial per-shard pair-buffer capacity hint for
              emit='pairs'; regrown automatically on overflow.
    fault_plan: a ``resilience.FaultPlan`` (or spec string, or "" for an
              explicitly-armed empty plan) enabling the per-task
              retry/degradation ladder (DESIGN.md §12); defaults to
              ``REPRO_FAULT`` from the environment via ``build_resilience``.
    checkpoint_dir: directory for the shard task ledger; completed shard
              tasks are checkpointed and skipped on resume (bit-identical
              output, ``stats['tasks_resumed']`` counts the skips).
    schedule: mesh-lfvt shard-body tile schedule — 'planned' (the
              default) plans the live row
              tiles on the device and walks them with K6; 'static' walks
              every tile with K1. Bit-identical results either way; only
              ``walk_steps``/``live_tiles`` (and wall clock) move. Not
              read off the mesh-lfvt path (the loop path plans live tiles
              on the host).
    device:   'cuda' (the default) or 'cpu'; see ``resolve_device``. With
              a mesh it defaults to the mesh's first slot, where the
              resilience ladder's loop rung runs.

    ``pad`` defaults to ``global_config`` when None. ``plan`` optionally
    injects a precomputed ``core.planner.JoinPlan`` (the front door's
    path); when None the kwargs above are validated and resolved through
    ``core.planner.build_plan``.
    """
    if mesh is not None:
        check_mesh(mesh)
        if device is None:
            device = mesh.devices[0]
    device = resolve_device(device)
    if mesh is not None:
        axis = join_axis(mesh, axis)
    pad_explicit = pad is not None
    pad = pad or global_config.pad_mode
    validate_join_args(driver="mr", method=method, emit=emit, pad=pad,
                       pad_explicit=pad_explicit, schedule=schedule,
                       pair_capacity=pair_capacity,
                       has_mesh=mesh is not None)
    R.validate()
    S.validate()
    res = build_resilience(checkpoint_dir, fault_plan)
    if not len(R) or not len(S):
        if global_config.strict_validation:
            side = "R" if not len(R) else "S"
            raise EmptyCollectionError(
                f"empty {side} collection (strict_validation is on)")
        if stats is not None:  # consumers index these unconditionally
            stats.update(
                n_shards=0, emit=emit, measure=measure, result_pairs=0,
                pair_bytes=0,
                reduce_bytes=0, dense_mask_bytes=0, regrows=0,
                reduce_intermediate_peak_bytes=0, reduce_mask_peak_bytes=0,
                shuffle_bytes=0, shard_loads=[], max_load=0,
                r_replication=0.0, shard_block_bytes=0,
                shard_block_bytes_per_shard=0.0, pad_waste_max=0.0,
                pad_waste_mean=0.0, pad=pad, n_buckets=0, intervals=[],
                psi=0.0,
                plan=build_plan(R, S, t, driver="mr", method=method,
                                measure=measure, emit=emit,
                                has_mesh=mesh is not None, pad=pad,
                                pad_explicit=pad_explicit,
                                schedule=schedule,
                                pair_capacity=pair_capacity).to_dict())
            resilience_stats(stats, res)
        return set()
    # int32 exactness guard for the device predicate (DESIGN.md §8)
    get_measure(measure).validate(
        t, max(int(R.sizes().max(initial=0)), int(S.sizes().max(initial=0))))
    part = (load_aware_partition if strategy == "load_aware" else hash_partition)(
        R, S, t, n_shards, measure=measure)
    # resolve method='auto': the cost model scores the routed inputs —
    # per shard on the loop path, one homogeneous pick under a mesh
    # (a stacked bucket cannot mix rep families)
    if plan is None:
        plan = build_plan(R, S, t, driver="mr", method=method,
                          measure=measure, emit=emit,
                          has_mesh=mesh is not None, pad=pad,
                          pad_explicit=pad_explicit, schedule=schedule,
                          pair_capacity=pair_capacity, part=part)
    method = plan.method
    shard_methods = plan.shard_methods
    if stats is not None:
        stats["plan"] = plan.to_dict()
        if shard_methods is not None:
            stats["shard_methods"] = list(shard_methods)
    if res is not None and res.ledger.dir:
        res.ledger.open_run({
            "version": 1, "driver": "mr_cf_rs_join", "t": float(t),
            "n_shards": int(n_shards), "strategy": strategy,
            "method": method, "emit": emit, "measure": measure,
            "pad": pad, "R": collection_digest(R),
            "S": collection_digest(S)})
    if shard_methods is not None and mesh is None:
        if len(set(shard_methods)) > 1:
            # heterogeneous plan: per-shard dispatch on the loop path
            return _lfvt_loop_join(R, S, t, part, emit=emit,
                                   pair_capacity=pair_capacity,
                                   measure=measure, stats=stats,
                                   device=device, impl="kernel", res=res,
                                   shard_methods=shard_methods)
        # homogeneous per-shard pick: reuse the plain single-method paths
        method = shard_methods[0]
    if mesh is not None and mesh.shape.get(axis) != part.n_shards:
        raise ValueError(
            f"the mesh's {axis!r} axis has "
            f"{mesh.shape.get(axis)} slots (shape {mesh.shape}); it must "
            f"equal n_shards={part.n_shards}")
    if mesh is not None and len(mesh.axis_names) > 1:
        # shard k on the k-th slot along the axis (the other axes' first)
        mesh = Mesh(mesh.axis_devices(axis), (axis,))
    if method in ("lfvt", "lfvt_ref"):
        if mesh is not None:
            # lfvt_ref + mesh already rejected by validate_join_args
            return _lfvt_mesh_join(
                R, S, t, part, mesh, emit=emit,
                pad=pad if pad != "auto" else "bucket",
                pair_capacity=pair_capacity, measure=measure, stats=stats,
                device=device, res=res, schedule=schedule)
        return _lfvt_loop_join(R, S, t, part, emit=emit,
                               pair_capacity=pair_capacity, measure=measure,
                               stats=stats, device=device,
                               impl="ref" if method == "lfvt_ref" else
                               "kernel", res=res)
    pad_mode = pad if pad != "auto" else ("global" if mesh is not None
                                          else "bucket")
    if mesh is not None and pad_mode != "global":
        raise ValueError("shard_map path requires pad='global'")
    blocks, route_stats = shard_blocks(R, S, part, t, pad=pad_mode)

    pairs: set = set()
    dense_bytes = sum(b.n_local * b.m_pad * b.n_pad for b in blocks)
    cap_hint = pair_capacity if pair_capacity else global_config.pair_cap_grain
    kernel_loop = (mesh is None and emit == "pairs"
                   and method in ("kernel_bitmap", "kernel_onehot"))

    def zero_block_acc() -> dict:
        return {"reduce": 0, "result": 0, "regrows": 0, "peak_mask": 0,
                "peak_inter": 0, "live": 0, "total_tiles": 0}

    acc = zero_block_acc()

    def run_block(block, acc: dict, out_pairs: set, use_mesh) -> None:
        """One ShardBlock's reduce + emit (primary / loop rung body)."""
        if kernel_loop:
            per_shard, counts, out_b, rg, lv, tt, staged = (
                _kernel_block_pairs(block, t=t, method=method,
                                    cap_hint=pair_capacity, measure=measure,
                                    device=device))
            for lk, local in enumerate(per_shard):
                _emit_shard_pairs(block, lk, local, out_pairs)
            acc["reduce"] += out_b
            acc["regrows"] += rg
            acc["live"] += lv
            acc["total_tiles"] += tt
            acc["result"] += int(counts.sum())
            # the staged (L, TM, TN) live-tile masks are what resides on
            # device — tile padding can exceed the shard's m_pad*n_pad
            acc["peak_mask"] = max(acc["peak_mask"], staged)
            acc["peak_inter"] = max(acc["peak_inter"], staged)
        elif emit == "pairs":
            pairs_dev, counts, cap, rg = _block_pairs_reduce(
                block, t=t, method=method, cap_hint=cap_hint,
                measure=measure, device=device, mesh=use_mesh)
            _collect_block_pairs(block, pairs_dev, counts, out_pairs)
            # variable-length reduce output: each shard ships its exact
            # slice + one count; the cap buffer never leaves the device
            acc["reduce"] += int(counts.sum()) * 8 + block.n_local * 4
            acc["regrows"] += rg
            acc["result"] += int(counts.sum())
            # one shard-local mask at a time + the compacted per-shard
            # output buffers
            acc["peak_mask"] = max(acc["peak_mask"],
                                   block.m_pad * block.n_pad)
            acc["peak_inter"] = max(
                acc["peak_inter"],
                block.m_pad * block.n_pad + block.n_local * (cap * 8 + 4))
        else:
            if use_mesh is not None:
                masks = _shard_map_reduce(block, use_mesh, t=t,
                                          method=method, measure=measure)
            else:
                masks = _loop_reduce(block, t=t, method=method,
                                     measure=measure, device=device)
            for lk in range(block.n_local):
                _emit_shard_pairs(block, lk, np.argwhere(masks[lk]),
                                  out_pairs)
            acc["reduce"] += masks.size
            acc["peak_mask"] = max(acc["peak_mask"], masks.size)
            acc["peak_inter"] = max(acc["peak_inter"], masks.size)

    if res is None:
        for block in blocks:
            run_block(block, acc, pairs, mesh)
    else:
        # resilience ladder per block (DESIGN.md §12): primary reduce ->
        # single-device loop rerun (mesh runs only) -> host oracle over
        # the shards' original sets (ids mapped back through R.ids/S.ids)
        from .join import brute_force_join  # deferred: the oracle rung
        r_rowmap = {int(v): i for i, v in enumerate(np.asarray(R.ids))}
        s_rowmap = {int(v): i for i, v in enumerate(np.asarray(S.ids))}

        for bi, block in enumerate(blocks):
            def primary(use_mesh, block=block):
                def run():
                    sub_acc, sub_pairs = zero_block_acc(), set()
                    run_block(block, sub_acc, sub_pairs, use_mesh)
                    return sorted_pairs(sub_pairs), sub_acc
                return run

            def oracle(block=block):
                sub_acc, sub_pairs = zero_block_acc(), set()
                for lk in range(block.n_local):
                    rrows = np.asarray(
                        [r_rowmap[int(v)] for v in block.r_ids[lk] if v >= 0],
                        np.int64)
                    srows = np.asarray(
                        [s_rowmap[int(v)] for v in block.s_ids[lk] if v >= 0],
                        np.int64)
                    got = brute_force_join(_sub_collection(R, rrows),
                                           _sub_collection(S, srows), t,
                                           measure=measure)
                    sub_pairs.update(got)
                if emit == "pairs":
                    sub_acc["result"] = len(sub_pairs)
                return sorted_pairs(sub_pairs), sub_acc

            tid = f"block_join/{method}/{emit}/{measure}/block={bi}"
            rungs = [("mesh" if mesh is not None else method, primary(mesh))]
            if mesh is not None:
                rungs.append(("loop", primary(None)))
            rungs.append(("oracle", oracle))
            got, delta = res.run(tid, rungs)
            pairs.update((int(a), int(b)) for a, b in got)
            _fold_delta(acc, delta)

    n_result = len(pairs) if emit == "mask" else acc["result"]
    if stats is not None:
        stats.update(route_stats)
        stats["intervals"] = part.intervals
        stats["psi"] = part.psi
        stats["n_shards"] = part.n_shards
        stats["emit"] = emit
        stats["measure"] = measure
        stats["result_pairs"] = n_result
        # compacted result bytes: 2 int32 ids per qualifying pair — the
        # quantity the paper's shuffle/disk accounting charges the reduce
        # output with (vs the dense per-shard masks)
        stats["pair_bytes"] = n_result * 8
        stats["reduce_bytes"] = acc["reduce"]
        stats["dense_mask_bytes"] = dense_bytes
        stats["reduce_intermediate_peak_bytes"] = acc["peak_inter"]
        # largest boolean mask ever resident at once: one shard's
        # (m_pad, n_pad) for emit='pairs', the whole stacked bucket for
        # emit='mask'
        stats["reduce_mask_peak_bytes"] = acc["peak_mask"]
        stats["regrows"] = acc["regrows"]
        if kernel_loop:
            stats["live_tiles"] = acc["live"]
            stats["total_tiles"] = acc["total_tiles"]
        resilience_stats(stats, res)
    return pairs
