"""The flat-LFVT array walk over row tiles (K1, K6), on a CUDA GPU.

The port of the JAX package's ``kernels/lfvt_walk.py``. The R block is
sorted by set size (rows with near-identical Lemma-3.1 windows share a
tile) and cut into ``row_tile``-row tiles; tiles whose windows exclude
every S column are dead. Each live tile owns a ``(row_tile, NP)`` int32
count tile for its whole walk, and only the qualifying boolean sub-mask,
the exact pair count and the ``walk_steps``/``early_stops`` counters
leave it. On the card each row of a live tile is one CTA, whose counts
over the row's window sit in shared memory (``walk_pass_cols``).

Two schedules, each with a plain PyTorch version and a CUDA kernel of
``csrc/lfvt_walk.cu`` chosen by where the tensors lie (CPU: the plain
version; CUDA: the kernel, counted in the wrapper's ``launches``):

  * host plan (K1): ``plan_row_tiles`` lists the live tiles on the host
    and only those launch — ``lfvt_walk_live_tiled`` /
    ``lfvt_walk_live_tiled_ref``. The plain version batches every
    tile's lanes into one list that steps in lockstep, a scatter-add per
    step, dead lanes dropped as they die;
  * device plan (K6): ``plan_row_tiles_device`` partitions the tile ids
    on the device and leaves the live count there, so nothing waits for
    the device before the launch — ``lfvt_walk_planned`` /
    ``lfvt_walk_planned_ref``. Every tile gets a CTA; the dead ones
    write zeros.

There is no fallback from the CUDA path: a failed build or launch raises.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..core import measures
from . import _build

__all__ = ["TileShapeError", "WALK_MAX_COLS",
           "plan_row_tiles", "plan_row_tiles_device", "entry_state",
           "walk_vmem_tile_bytes", "walk_pass_cols", "walk_passes",
           "lfvt_walk_live_tiled", "lfvt_walk_live_tiled_ref",
           "lfvt_walk_planned", "lfvt_walk_planned_ref"]

def walk_vmem_tile_bytes(tm: int, lr: int, npad: int, tp: int) -> int:
    """Per-tile working set of the walk, by the reference's accounting.

    Two (tm, lr) int32 lane tiles, the (1, tp) int32 seq_row + seq_next
    rows, the (1, npad) int32 S-size row, three (tm, 1) int32 window
    columns, the (tm, npad) int32 count tile and the (tm, npad) bool
    mask tile. Kept so the ``walk_vmem_tile_bytes`` stat means the same
    in both packages; on the GPU each row's counts over its window live in
    its CTA's shared memory (``walk_pass_cols``), not in a per-core
    scratchpad.
    """
    return (4 * (2 * tm * lr + 2 * tp + npad + 3 * tm + tm * npad)
            + tm * npad)


#: int32 count columns one walk CTA holds in shared memory at most (224 KiB
#: of the 227 KB an sm_90 block may use; ``kMaxCols`` of csrc/lfvt_walk.cu)
WALK_MAX_COLS = 57344


def walk_pass_cols(np_cols: int) -> int:
    """The count columns each CTA of a walk launch keeps in shared memory.

    A CTA walks one row, and its counts cover the row's window from the
    window's start rounded down to 16 columns, so ``np_cols`` rounded up
    to 16 hold any window in one pass. Past ``WALK_MAX_COLS`` a wider
    window takes several column passes (``walk_passes``). A walk CTA has
    1 024 threads of 64 registers, the whole register file of an SM, so
    one CTA runs on an SM at any ``cols``."""
    return min(max((np_cols + 15) // 16 * 16, 16), WALK_MAX_COLS)


def walk_passes(lo: np.ndarray, hi: np.ndarray, np_cols: int,
                cols: int) -> np.ndarray:
    """Column passes the kernel makes for each row of host windows
    ``lo``/``hi`` at ``cols`` count columns: its window clamped to
    ``[0, np_cols)``, from the start rounded down to 16 columns, in passes
    of ``cols``; one pass (for the counters) when the window is empty."""
    lo = np.maximum(np.asarray(lo, np.int64), 0)
    hi = np.minimum(np.asarray(hi, np.int64), np_cols)
    span = hi - (lo & ~15)
    return np.where(lo < hi, -(-span // cols), 1)


class TileShapeError(ValueError):
    """A row-count / row-tile mismatch that would silently mis-plan.

    The tile planner reshapes ``(rows,)`` window arrays into
    ``(rows // tm, tm)`` tiles; callers pad rows to the tile multiple
    *before* planning (``ops`` pads with empty ``[0, 0)`` windows, which
    can never qualify)."""


def _check_tile_rows(n_rows: int, tm: int, who: str) -> int:
    if tm <= 0:
        raise TileShapeError(f"{who}: row tile must be positive, got {tm}")
    if n_rows % tm:
        raise TileShapeError(
            f"{who}: {n_rows} rows is not a multiple of row_tile={tm}; "
            f"pad the trailing {n_rows % tm} rows to the tile boundary "
            "with empty [0, 0) windows before planning")
    return n_rows // tm


def plan_row_tiles(lo: np.ndarray, hi: np.ndarray, tm: int) -> np.ndarray:
    """Live row-tile ids: tiles where at least one row has a non-empty
    [lo, hi) window. Everything else is skipped before launch; host numpy
    because the result sizes the grid. Raises ``TileShapeError`` on a
    ragged tail."""
    m_tiles = _check_tile_rows(len(lo), tm, "plan_row_tiles")
    live = (np.asarray(lo).reshape(m_tiles, tm)
            < np.asarray(hi).reshape(m_tiles, tm)).any(axis=1)
    return np.nonzero(live)[0].astype(np.int32)


def plan_row_tiles_device(lo: torch.Tensor, hi: torch.Tensor, tm: int):
    """Device twin of ``plan_row_tiles``: the same live criterion
    (``any(lo < hi)`` per row tile), computed on the windows' device,
    with no copy back to the host.

    Returns ``(ti_sorted (m_tiles,) int32, n_live () int32)``, both on
    that device: the tile ids stable-partitioned so the live ones come
    first in ascending order (the key ``dead * m_tiles + tile_id`` is
    unique, so any sort keeps that order) and ``ti_sorted[:n_live] ==
    plan_row_tiles(lo, hi, tm)``; the dead tail is ascending too.
    """
    lo1, hi1 = lo.reshape(-1), hi.reshape(-1)
    m_tiles = _check_tile_rows(lo1.shape[0], tm, "plan_row_tiles_device")
    live = (lo1.reshape(m_tiles, tm) < hi1.reshape(m_tiles, tm)).any(dim=1)
    ids = torch.arange(m_tiles, dtype=torch.int32, device=lo.device)
    key = torch.where(live, 0, m_tiles).to(torch.int32) + ids
    return (ids[torch.argsort(key)].contiguous(),
            live.sum(dtype=torch.int32))


def entry_state(dev, r_padded: torch.Tensor):
    """Resolve the per-R-element entry rows: (mb, Lr) element lists ->
    lane (walk position, remaining steps) int32 pairs, parked at (0, 0)
    for -1 pads and absent elements (binary search over the sparse entry
    table).

    Each row's lanes come back sorted by remaining walk length
    (descending, stable — the reference's ``jnp.argsort(-rem)``), so the
    lane arrays are equal element for element. Counts, masks and the
    step/stop counters do not depend on lane order."""
    a = r_padded.to(torch.int32)
    E = dev.entry_elem.shape[0]
    if E == 0:
        zero = torch.zeros_like(a)
        return zero, zero.clone()
    idx = torch.clamp(torch.searchsorted(dev.entry_elem, a), max=E - 1)
    present = (a >= 0) & (dev.entry_elem[idx] == a)
    zero = torch.zeros((), dtype=torch.int32, device=a.device)
    pos = torch.where(
        present, dev.node_seq_off[dev.entry_node[idx].long()]
        + dev.entry_off[idx], zero).to(torch.int32)
    rem = torch.where(present, dev.entry_len[idx], zero).to(torch.int32)
    order = torch.argsort(-rem, dim=1, stable=True)
    return (torch.gather(pos, 1, order).contiguous(),
            torch.gather(rem, 1, order).contiguous())


def _qualify(counts, r_sz, s_sz, lo, hi, t, measure):
    """Measure predicate + [lo, hi) column window on a count tile."""
    cols = torch.arange(counts.shape[1], dtype=torch.int32,
                        device=counts.device)[None, :]
    in_window = (cols >= lo) & (cols < hi)
    return measures.device_qualify(counts, r_sz, s_sz, t, measure) & in_window


# ---------------------------------------------------------------------- #
# plain PyTorch version — the CPU path and the kernel's oracle
# ---------------------------------------------------------------------- #
#: steps between the plain walk's compactions to its live lanes
COMPACT_EVERY = 32


def lfvt_walk_live_tiled_ref(ti, lane_pos, lane_rem, nxt2d, seq2d, ssz2d,
                             rsz, lo, hi, *, t: float, measure: str,
                             max_steps: int, tm: int):
    """Plain PyTorch version of ``lfvt_walk_live_tiled``.

    The lockstep walk of the reference's live-lane staircase, narrowed
    to the live lanes every ``COMPACT_EVERY`` steps instead of at pow2
    lane boundaries: the live tiles' lanes are flattened into one list,
    each step gathers their rows and hops and scatter-adds 1 into the
    (L·tm, NP) count block for the lanes still live (a dead lane rides
    along, masked, until the next compaction drops it). A tile's step
    counter advances in the steps where it still has a live lane, so
    masks, counts and counters equal running each tile's walk on its own
    — and equal the reference's, which the tests pin. A compaction is the
    loop's only host sync: the walk takes up to ``max_steps`` (~10^5 on
    livej) steps of a few small kernels each, and syncing every step
    made it ~3x slower on the card.

    Returns (masks (L, tm, NP) bool, counts/steps/stops (L, 1) int32).
    """
    Lr = lane_pos.shape[1]
    NP = ssz2d.shape[1]
    L = ti.shape[0]
    M = L * tm
    device = lane_pos.device
    seq = seq2d[0].long()
    nxt = nxt2d[0].long()
    til = ti.long()
    r_sz = rsz.reshape(-1, tm)[til].reshape(M, 1)
    lo_c = lo.reshape(-1, tm)[til].reshape(M, 1)
    hi_c = hi.reshape(-1, tm)[til].reshape(M, 1)
    rem = lane_rem.reshape(-1, tm, Lr)[til].reshape(-1).long()
    pos = lane_pos.reshape(-1, tm, Lr)[til].reshape(-1).long()
    lane_row = torch.arange(M * Lr, device=device) // max(Lr, 1)
    live = rem > 0
    rem, pos, lane_row = rem[live], pos[live], lane_row[live]
    lo_l = lo_c[:, 0].long()
    counts = torch.zeros(M * NP, dtype=torch.int32, device=device)
    stops = torch.zeros(L, dtype=torch.int64, device=device)
    steps_t = torch.zeros(L, dtype=torch.int64, device=device)
    step, n = 0, rem.numel()
    while step < max_steps and n:
        live = rem > 0
        tile = lane_row // tm
        steps_t += torch.zeros(L, dtype=torch.int64, device=device
                               ).index_add_(0, tile, live.long()) > 0
        row = seq[pos]
        counts.index_add_(0, lane_row * NP + row, live.to(torch.int32))
        # window early stop (Theorem 3.3): walk rows strictly decrease,
        # so row < lo means every later step is out of the window too
        stop = row < lo_l[lane_row]
        stops.index_add_(0, tile, (live & stop & (rem > 1)).long())
        rem = torch.where(stop, 0, rem - 1)     # a dead lane stays <= 0
        pos = torch.clamp(nxt[pos], min=0)
        step += 1
        if step % COMPACT_EVERY == 0:
            keep = (rem > 0).nonzero()[:, 0]
            rem, pos, lane_row = rem[keep], pos[keep], lane_row[keep]
            n = rem.numel()
    q = _qualify(counts.reshape(M, NP), r_sz, ssz2d, lo_c, hi_c, t, measure)
    masks = q.reshape(L, tm, NP)
    cnts = masks.sum(dim=(1, 2), dtype=torch.int32)
    return (masks, cnts.reshape(L, 1), steps_t.to(torch.int32).reshape(L, 1),
            stops.to(torch.int32).reshape(L, 1))


def lfvt_walk_planned_ref(ti_sorted, n_live, lane_pos, lane_rem, nxt2d,
                          seq2d, ssz2d, rsz, lo, hi, *, t: float,
                          measure: str, max_steps: int, tm: int):
    """Plain PyTorch version of ``lfvt_walk_planned``: walk only the live
    prefix of a ``plan_row_tiles_device`` schedule.

    The live prefix ``ti_sorted[:n_live]`` is walked in one
    ``lfvt_walk_live_tiled_ref`` call and its outputs are scattered into
    the zeroed full tile range. (The reference walks it in fixed-size
    chunks because its grid needs static shapes; a tile's outputs depend
    only on its own rows, so the result is the same.) Reads ``n_live``
    on the host (this is the oracle, not the kernel).

    Returns (masks (m_tiles, tm, NP) bool, counts/steps/stops
    (m_tiles, 1) int32) over the full tile range in tile order; dead
    tiles are all zero.
    """
    m_tiles = ti_sorted.shape[0]
    NP = ssz2d.shape[1]
    device = lane_pos.device
    _check_tile_rows(rsz.shape[0], tm, "lfvt_walk_planned_ref")
    masks = torch.zeros((m_tiles, tm, NP), dtype=torch.bool, device=device)
    outs = torch.zeros((3, m_tiles, 1), dtype=torch.int32, device=device)
    ti_l = ti_sorted[:int(n_live)].long()
    mk, *cols = lfvt_walk_live_tiled_ref(
        ti_l, lane_pos, lane_rem, nxt2d, seq2d, ssz2d, rsz, lo, hi, t=t,
        measure=measure, max_steps=max_steps, tm=tm)
    masks[ti_l] = mk
    for k, col in enumerate(cols):
        outs[k, ti_l] = col
    return masks, outs[0], outs[1], outs[2]


# ---------------------------------------------------------------------- #
# CUDA kernel wrappers
# ---------------------------------------------------------------------- #
_OPERANDS = ("lane_pos", "lane_rem", "nxt2d", "seq2d", "ssz2d", "rsz", "lo",
             "hi")


def _check_walk(who: str, lead, operands, tm: int):
    """Raise unless the schedule tensors ``lead`` ((name, tensor, shape)
    triples) and the walk's eight operands lie on the lanes' device as
    contiguous int32 of consistent shapes -> (Mp, Lr, NP)."""
    Mp, Lr = operands[0].shape
    Tp, NP = operands[3].shape[1], operands[4].shape[1]
    _check_tile_rows(Mp, tm, who)
    shapes = ((Mp, Lr), (Mp, Lr), (1, Tp), (1, Tp), (1, NP), (Mp, 1),
              (Mp, 1), (Mp, 1))
    for name, x, shape in [*lead, *zip(_OPERANDS, operands, shapes)]:
        _build.check_operand(who, name, x, shape, operands[0].device,
                             torch.int32)
    return Mp, Lr, NP


@functools.cache
def _launcher():
    """The kernel's C entry point, built from ``csrc/lfvt_walk.cu`` at
    first use (``kernels/_build.py``)."""
    fn = _build.load("lfvt_walk").lfvt_walk_live_tiled_launch
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    # ti, L, lane_pos, lane_rem, Lr, nxt, seq, ssz, NP, rsz, lo, hi, tm,
    # max_steps, measure, p, q, cols, mask, counts, steps, stops, stream
    fn.argtypes = ([ptr, i32, ptr, ptr, i32, ptr, ptr, ptr, i32, ptr, ptr,
                    ptr, i32, i32, i32, i32, i32, i32] + [ptr] * 5)
    fn.restype = i32
    return fn


def lfvt_walk_live_tiled(ti, lane_pos, lane_rem, nxt2d, seq2d, ssz2d, rsz,
                         lo, hi, *, t: float, measure: str, max_steps: int,
                         tm: int):
    """Flat-LFVT walk over live row tiles (K1); see
    ops.lfvt_walk_join_pairs_dispatch.

    ti (L,) live row-tile ids; lane_pos/lane_rem (Mp, Lr) resolved entry
    lanes (``entry_state``); nxt2d/seq2d (1, Tp) fused hop column and
    tuple rows; ssz2d (1, NP) padded S sizes; rsz/lo/hi (Mp, 1) — all
    int32, with 0 <= lo <= hi <= NP. Returns (mask (L, tm, NP) bool,
    counts, walk_steps, early_stops — each (L, 1) int32), on the inputs'
    device. CPU tensors run the plain version; CUDA tensors launch the
    kernel (one CTA per row of each live tile) on the current stream
    without synchronising.
    """
    device = lane_pos.device
    if device.type == "cpu":
        return lfvt_walk_live_tiled_ref(
            ti, lane_pos, lane_rem, nxt2d, seq2d, ssz2d, rsz, lo, hi, t=t,
            measure=measure, max_steps=max_steps, tm=tm)
    if device.type != "cuda":
        raise ValueError(f"lfvt_walk_live_tiled: no kernel for {device}")
    L = ti.shape[0]
    Mp, Lr, NP = _check_walk(
        "lfvt_walk_live_tiled", [("ti", ti, (L,))],
        (lane_pos, lane_rem, nxt2d, seq2d, ssz2d, rsz, lo, hi), tm)
    p, q = measures.threshold_fraction(t)
    code = measures.MEASURE_CODES[measures.get_measure(measure).name]
    masks = torch.empty((L, tm, NP), dtype=torch.bool, device=device)
    # the CTAs of a tile add into its counters
    outs = torch.zeros((3, L, 1), dtype=torch.int32, device=device)
    if L == 0:
        return masks, outs[0], outs[1], outs[2]
    fn = _launcher()
    err = fn(ti.data_ptr(), L, lane_pos.data_ptr(), lane_rem.data_ptr(), Lr,
             nxt2d.data_ptr(), seq2d.data_ptr(), ssz2d.data_ptr(), NP,
             rsz.data_ptr(), lo.data_ptr(), hi.data_ptr(), tm,
             int(max_steps), code, p, q, walk_pass_cols(NP),
             masks.data_ptr(), outs[0].data_ptr(), outs[1].data_ptr(),
             outs[2].data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    _build.check_launch("lfvt_walk_live_tiled", err)
    lfvt_walk_live_tiled.launches += 1
    return masks, outs[0], outs[1], outs[2]


lfvt_walk_live_tiled.launches = 0


@functools.cache
def _planned_launcher():
    """K6's C entry point, in the same library as K1's."""
    fn = _build.load("lfvt_walk").lfvt_walk_planned_launch
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    # ti_sorted, n_live, m_tiles, then K1's arguments from lane_pos on
    fn.argtypes = ([ptr, ptr, i32, ptr, ptr, i32, ptr, ptr, ptr, i32, ptr,
                    ptr, ptr, i32, i32, i32, i32, i32, i32] + [ptr] * 5)
    fn.restype = i32
    return fn


def lfvt_walk_planned(ti_sorted, n_live, lane_pos, lane_rem, nxt2d, seq2d,
                      ssz2d, rsz, lo, hi, *, t: float, measure: str,
                      max_steps: int, tm: int):
    """The walk over a device-planned schedule (K6); see
    ops.lfvt_walk_join_pairs_dispatch with ``schedule="device"``.

    ti_sorted (m_tiles,) and n_live () come from
    ``plan_row_tiles_device`` and stay on the device: the kernel runs
    one CTA per row of every tile slot, and the CTAs of slot ``l`` walk
    tile ``ti_sorted[l]`` when ``l < n_live`` (read in the kernel) and
    write zeros otherwise. The other operands are K1's. Returns (mask
    (m_tiles, tm, NP) bool, counts, walk_steps, early_stops — each
    (m_tiles, 1) int32) in tile order. CPU tensors run the plain
    version; CUDA tensors launch the kernel on the current stream and
    never wait for the device.
    """
    device = lane_pos.device
    if device.type == "cpu":
        return lfvt_walk_planned_ref(
            ti_sorted, n_live, lane_pos, lane_rem, nxt2d, seq2d, ssz2d, rsz,
            lo, hi, t=t, measure=measure, max_steps=max_steps, tm=tm)
    if device.type != "cuda":
        raise ValueError(f"lfvt_walk_planned: no kernel for {device}")
    m_tiles = ti_sorted.shape[0]
    Mp, Lr, NP = _check_walk(
        "lfvt_walk_planned",
        [("ti_sorted", ti_sorted, (m_tiles,)), ("n_live", n_live, ())],
        (lane_pos, lane_rem, nxt2d, seq2d, ssz2d, rsz, lo, hi), tm)
    if Mp // tm != m_tiles:
        raise TileShapeError(
            f"lfvt_walk_planned: {Mp} rows make {Mp // tm} row tiles of "
            f"{tm}, but ti_sorted names {m_tiles}")
    if NP % 16:
        raise ValueError(f"lfvt_walk_planned: NP={NP} is not a multiple of "
                         "16 (the dead tiles' mask rows are zeroed in "
                         "16-byte stores)")
    p, q = measures.threshold_fraction(t)
    code = measures.MEASURE_CODES[measures.get_measure(measure).name]
    masks = torch.empty((m_tiles, tm, NP), dtype=torch.bool, device=device)
    # dead tiles keep these zeros; the CTAs of a live tile add into them
    outs = torch.zeros((3, m_tiles, 1), dtype=torch.int32, device=device)
    if m_tiles == 0:
        return masks, outs[0], outs[1], outs[2]
    err = _planned_launcher()(
        ti_sorted.data_ptr(), n_live.data_ptr(), m_tiles, lane_pos.data_ptr(),
        lane_rem.data_ptr(), Lr, nxt2d.data_ptr(), seq2d.data_ptr(),
        ssz2d.data_ptr(), NP, rsz.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        tm, int(max_steps), code, p, q, walk_pass_cols(NP),
        masks.data_ptr(),
        outs[0].data_ptr(), outs[1].data_ptr(), outs[2].data_ptr(),
        torch.cuda.current_stream(device).cuda_stream)
    _build.check_launch("lfvt_walk_planned", err)
    lfvt_walk_planned.launches += 1
    return masks, outs[0], outs[1], outs[2]


lfvt_walk_planned.launches = 0
