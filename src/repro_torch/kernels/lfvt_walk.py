"""The flat-LFVT array walk over live row tiles (K1), on a CUDA GPU.

The port of the JAX package's ``kernels/lfvt_walk.py``. The R block is
sorted by set size (rows with near-identical Lemma-3.1 windows share a
tile) and cut into ``row_tile``-row tiles; tiles whose windows exclude
every S column never launch (``plan_row_tiles``). Each live tile owns a
``(row_tile, NP)`` int32 count tile for its whole walk, and only the
qualifying boolean sub-mask, the exact pair count and the
``walk_steps``/``early_stops`` counters leave it.

Two implementations of one function, chosen by where the tensors lie:

  * ``lfvt_walk_live_tiled_ref`` — the plain PyTorch version: every
    tile's lanes batched into one list that steps in lockstep, a
    scatter-add per step, dead lanes dropped as they die. The CPU path,
    and the kernel's oracle on the card.
  * ``lfvt_walk_live_tiled`` — the wrapper. On CPU tensors it calls the
    plain version; on CUDA tensors it launches the hand-written kernel
    of ``csrc/lfvt_walk.cu`` and counts the launch in
    ``lfvt_walk_live_tiled.launches``. There is no fallback from the
    CUDA path: a failed build or launch raises.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..core import measures

__all__ = ["TileShapeError",
           "plan_row_tiles", "entry_state", "walk_vmem_tile_bytes",
           "lfvt_walk_live_tiled", "lfvt_walk_live_tiled_ref"]

def walk_vmem_tile_bytes(tm: int, lr: int, npad: int, tp: int) -> int:
    """Per-tile working set of the walk, by the reference's accounting.

    Two (tm, lr) int32 lane tiles, the (1, tp) int32 seq_row + seq_next
    rows, the (1, npad) int32 S-size row, three (tm, 1) int32 window
    columns, the (tm, npad) int32 count tile and the (tm, npad) bool
    mask tile. Kept so the ``walk_vmem_tile_bytes`` stat means the same
    in both packages; on the GPU the count tile lives in device memory
    (see ``csrc/lfvt_walk.cu``), not in a per-core scratchpad.
    """
    return (4 * (2 * tm * lr + 2 * tp + npad + 3 * tm + tm * npad)
            + tm * npad)


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
def lfvt_walk_live_tiled_ref(ti, lane_pos, lane_rem, nxt2d, seq2d, ssz2d,
                             rsz, lo, hi, *, t: float, measure: str,
                             max_steps: int, tm: int):
    """Plain PyTorch version of ``lfvt_walk_live_tiled``.

    The lockstep walk of the reference's live-lane staircase, narrowed
    to the live lanes at every step instead of at pow2 lane boundaries:
    the live tiles' lanes are flattened into one list, each step gathers
    their rows and hops, scatter-adds 1 into the (L·tm, NP) count block,
    and drops the lanes that died. A tile's step counter advances in the
    steps where it still has a live lane, so masks, counts and counters
    equal running each tile's walk on its own — and equal the
    reference's, which the tests pin.

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
    step = 0
    while step < max_steps and rem.numel():
        tile = lane_row // tm
        steps_t += torch.bincount(tile, minlength=L) > 0
        row = seq[pos]
        counts.index_add_(0, lane_row * NP + row,
                          torch.ones_like(row, dtype=torch.int32))
        # window early stop (Theorem 3.3): walk rows strictly decrease,
        # so row < lo means every later step is out of the window too
        stop = row < lo_l[lane_row]
        stops += torch.bincount(tile[stop & (rem > 1)], minlength=L)
        rem = torch.where(stop, 0, rem - 1)
        pos = torch.clamp(nxt[pos], min=0)
        live = rem > 0
        rem, pos, lane_row = rem[live], pos[live], lane_row[live]
        step += 1
    q = _qualify(counts.reshape(M, NP), r_sz, ssz2d, lo_c, hi_c, t, measure)
    masks = q.reshape(L, tm, NP)
    cnts = masks.sum(dim=(1, 2), dtype=torch.int32)
    return (masks, cnts.reshape(L, 1), steps_t.to(torch.int32).reshape(L, 1),
            stops.to(torch.int32).reshape(L, 1))


# ---------------------------------------------------------------------- #
# CUDA kernel wrapper
# ---------------------------------------------------------------------- #
@functools.cache
def _launcher():
    """The kernel's C entry point, built from ``csrc/lfvt_walk.cu`` at
    first use (``kernels/_build.py``)."""
    from . import _build
    fn = _build.load("lfvt_walk").lfvt_walk_live_tiled_launch
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    # ti, L, lane_pos, lane_rem, Lr, nxt, seq, ssz, NP, rsz, lo, hi, tm,
    # max_steps, measure, p, q, scratch, mask, counts, steps, stops, stream
    fn.argtypes = ([ptr, i32, ptr, ptr, i32, ptr, ptr, ptr, i32, ptr, ptr,
                    ptr, i32, i32, i32, i32, i32] + [ptr] * 6)
    fn.restype = i32
    return fn


def _check_operand(name: str, x: torch.Tensor, shape, device) -> None:
    if x.device != device:
        raise ValueError(f"lfvt_walk_live_tiled: {name} is on {x.device}, "
                         f"expected {device}")
    if x.dtype != torch.int32:
        raise ValueError(f"lfvt_walk_live_tiled: {name} must be int32, "
                         f"got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"lfvt_walk_live_tiled: {name} has shape "
                         f"{tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"lfvt_walk_live_tiled: {name} is not contiguous")


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
    kernel on the current stream without synchronising.
    """
    device = lane_pos.device
    if device.type == "cpu":
        return lfvt_walk_live_tiled_ref(
            ti, lane_pos, lane_rem, nxt2d, seq2d, ssz2d, rsz, lo, hi, t=t,
            measure=measure, max_steps=max_steps, tm=tm)
    if device.type != "cuda":
        raise ValueError(f"lfvt_walk_live_tiled: no kernel for {device}")
    L = ti.shape[0]
    Mp, Lr = lane_pos.shape
    Tp, NP = seq2d.shape[1], ssz2d.shape[1]
    _check_tile_rows(Mp, tm, "lfvt_walk_live_tiled")
    for name, x, shape in (("ti", ti, (L,)), ("lane_pos", lane_pos, (Mp, Lr)),
                           ("lane_rem", lane_rem, (Mp, Lr)),
                           ("nxt2d", nxt2d, (1, Tp)), ("seq2d", seq2d, (1, Tp)),
                           ("ssz2d", ssz2d, (1, NP)), ("rsz", rsz, (Mp, 1)),
                           ("lo", lo, (Mp, 1)), ("hi", hi, (Mp, 1))):
        _check_operand(name, x, shape, device)
    p, q = measures.threshold_fraction(t)
    code = measures.MEASURE_CODES[measures.get_measure(measure).name]
    masks = torch.empty((L, tm, NP), dtype=torch.bool, device=device)
    outs = torch.empty((3, L, 1), dtype=torch.int32, device=device)
    if L == 0:
        return masks, outs[0], outs[1], outs[2]
    # global count tile per live row tile; the kernel zeroes the window
    # columns it reads and never touches the rest
    scratch = torch.empty((L, tm, NP), dtype=torch.int32, device=device)
    fn = _launcher()
    err = fn(ti.data_ptr(), L, lane_pos.data_ptr(), lane_rem.data_ptr(), Lr,
             nxt2d.data_ptr(), seq2d.data_ptr(), ssz2d.data_ptr(), NP,
             rsz.data_ptr(), lo.data_ptr(), hi.data_ptr(), tm,
             int(max_steps), code, p, q, scratch.data_ptr(),
             masks.data_ptr(), outs[0].data_ptr(), outs[1].data_ptr(),
             outs[2].data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lfvt_walk_live_tiled: CUDA launch failed with "
                           f"error {err}")
    lfvt_walk_live_tiled.launches += 1
    return masks, outs[0], outs[1], outs[2]


lfvt_walk_live_tiled.launches = 0
