"""The one-hot membership-product join over tiles (K4, K5), on a CUDA GPU.

The port of the JAX package's ``kernels/onehot_join.py``: the same
function as ``bitmap_join`` (per (TM, TN) tile the intersection sizes,
then the measure predicate and the window), with the sizes taken as a
product of 0/1 membership matrices, ``F = B_R @ B_S^T``, unpacked from
the same uint32 bitmap words.

  * ``onehot_join_tiled`` (K5) — every tile, gated by a skip mask, into
    the dense (M, N) mask;
  * ``onehot_join_live_tiled`` (K4) — the live (i, j) tiles only, into
    an (L, TM, TN) mask and (L, 1) counts.

The kernels (``csrc/onehot_join.cu``) run one CTA per tile: a warpgroup
expands each bitmap word once into int8 0/1 operands in shared memory
while one or two others multiply them with ``wgmma`` on the card's int8
tensor cores into int32 accumulators, exact at any size; they take
tiles of at most 128 rows by 128 or 256 columns (every tile
``ops.pick_tiles`` gives). K4's CTAs take the live tiles column tile by
column tile (``cta_order``), so the tiles that run together
share their S words in the L2 cache. The plain PyTorch
versions multiply float32 0/1 matrices in universe chunks (exact: every
partial count is an integer below 2^24, and 0 and 1 survive TF32's
rounding of the inputs). Wrappers take the plain version on CPU tensors
only, launch the kernel on CUDA tensors and count the launch in
``<wrapper>.launches``; there is no fallback.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..core import measures
from ..core.tile_join import qualify, stage_budget
from . import _build
from .bitmap_join import (_check_operands, _device_of, live_tiled_ref,
                          tiled_ref)

__all__ = ["DEFAULT_TILES", "membership_counts", "cta_order",
           "onehot_join_tiled", "onehot_join_live_tiled",
           "onehot_join_tiled_ref", "onehot_join_live_tiled_ref"]

#: (TM, TN, TW), the reference's (its matmul depth TW*32 = 256)
DEFAULT_TILES = (128, 256, 8)


# ---------------------------------------------------------------------- #
# plain PyTorch versions — the CPU path and the kernels' oracles
# ---------------------------------------------------------------------- #
def _membership(words: torch.Tensor, dtype) -> torch.Tensor:
    """(rows, w) int32-held uint32 words -> (rows, 32w) 0/1 matrix; bit
    ``b`` of word ``k`` is column ``32k + b``. (An arithmetic shift of the
    int32 word still brings bit ``b`` down to bit 0.)"""
    bits = torch.arange(32, dtype=torch.int32, device=words.device)
    return ((words[:, :, None] >> bits) & 1).reshape(
        words.shape[0], -1).to(dtype)


def membership_counts(r_bitmaps: torch.Tensor,
                      s_bitmaps: torch.Tensor) -> torch.Tensor:
    """(m, W) x (n, W) bitmap words -> (m, n) int32 intersection sizes as
    the float32 product of the unpacked membership matrices, in universe
    chunks that keep each unpacked matrix within the device's
    ``stage_budget``."""
    m, W = r_bitmaps.shape
    n = s_bitmaps.shape[0]
    device = r_bitmaps.device
    step = max(1, stage_budget(device) // (4 * 32 * max(m, n, 1)))
    out = torch.zeros((m, n), dtype=torch.int32, device=device)
    for w0 in range(0, W, step):
        br = _membership(r_bitmaps[:, w0:w0 + step], torch.float32)
        bs = _membership(s_bitmaps[:, w0:w0 + step], torch.float32)
        out += (br @ bs.T).to(torch.int32)
    return out


def _onehot_qualify(r_bm, r_sz, s_bm, s_sz, col_lo, col_hi, *, t,
                    measure="jaccard") -> torch.Tensor:
    """Membership-product counts, the predicate and the [lo, hi) window
    -> (m, n) bool."""
    counts = membership_counts(r_bm, s_bm)
    cols = torch.arange(s_bm.shape[0], device=counts.device)[None, :]
    in_window = (cols >= col_lo[:, None]) & (cols < col_hi[:, None])
    return qualify(counts, r_sz, s_sz, t, measure) & in_window


def onehot_join_tiled_ref(r_bitmaps, r_sizes, s_bitmaps, s_sizes, lo, hi,
                          skip, *, t: float, measure: str = "jaccard",
                          tiles=DEFAULT_TILES):
    """Plain version of ``onehot_join_tiled``: ``_onehot_qualify`` on
    every tile that the skip mask keeps."""
    return tiled_ref(_onehot_qualify, r_bitmaps, r_sizes, s_bitmaps,
                     s_sizes, lo, hi, skip, t=t, measure=measure,
                     tiles=tiles)


def onehot_join_live_tiled_ref(tile_i, tile_j, r_bitmaps, r_sizes,
                               s_bitmaps, s_sizes, lo, hi, *, t: float,
                               measure: str = "jaccard",
                               tiles=DEFAULT_TILES):
    """Plain version of ``onehot_join_live_tiled``: ``_onehot_qualify``
    per live tile."""
    return live_tiled_ref(_onehot_qualify, tile_i, tile_j, r_bitmaps,
                          r_sizes, s_bitmaps, s_sizes, lo, hi, t=t,
                          measure=measure, tiles=tiles)


# ---------------------------------------------------------------------- #
# CUDA kernel wrappers
# ---------------------------------------------------------------------- #
@functools.cache
def _launchers():
    """(tiled, live) C entry points of ``csrc/onehot_join.cu`` (K5, K4),
    built at first use (``kernels/_build.py``)."""
    so = _build.load("onehot_join")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    tiled = so.onehot_join_tiled_launch
    # r, s, rsz, ssz, lo, hi, skip, M, N, W, tm, tn, measure, p, q, out,
    # stream
    tiled.argtypes = [ptr] * 7 + [i32] * 8 + [ptr, ptr]
    tiled.restype = i32
    live = so.onehot_join_live_tiled_launch
    # ti, tj, order, L, r, s, rsz, ssz, lo, hi, N, W, tm, tn, measure, p,
    # q, mask, counts, stream
    live.argtypes = [ptr] * 3 + [i32] + [ptr] * 6 + [i32] * 7 + [ptr] * 3
    live.restype = i32
    return tiled, live


def _quad_words(r_bitmaps, s_bitmaps, W):
    """The kernels read each row's words in 16-byte pieces: the bitmaps
    with their word axis zero-padded to a multiple of 4 (a copy; zero
    words add nothing to any count) -> (r, s, W)."""
    pad = -W % 4
    if pad:
        r_bitmaps, s_bitmaps = (torch.nn.functional.pad(x, (0, pad))
                                for x in (r_bitmaps, s_bitmaps))
    return r_bitmaps, s_bitmaps, W + pad


def cta_order(tile_i: torch.Tensor, tile_j: torch.Tensor,
              m_tiles: int) -> torch.Tensor:
    """The order in which K4's CTAs take the live tiles: column tile by
    column tile, row tiles ascending within each (one stable sort of
    ``tile_j * m_tiles + tile_i``), so the CTAs that run together share
    their S words in the L2 cache -> (L,) int32 permutation of the tile
    indices, on their device."""
    key = tile_j.long() * m_tiles + tile_i.long()
    return torch.argsort(key, stable=True).to(torch.int32)


def _threshold(t, measure):
    """(p, q, measure code) as the kernels take them."""
    p, q = measures.threshold_fraction(t)
    return p, q, measures.MEASURE_CODES[measures.get_measure(measure).name]


def onehot_join_tiled(r_bitmaps, r_sizes, s_bitmaps, s_sizes, lo, hi, skip,
                      *, t: float, measure: str = "jaccard",
                      tiles=DEFAULT_TILES) -> torch.Tensor:
    """Dense one-hot join (K5); the contract of
    ``bitmap_join.bitmap_join_tiled``."""
    who = "onehot_join_tiled"
    if _device_of(r_bitmaps, who) == "cpu":
        return onehot_join_tiled_ref(r_bitmaps, r_sizes, s_bitmaps, s_sizes,
                                     lo, hi, skip, t=t, measure=measure,
                                     tiles=tiles)
    M, N, W = _check_operands("onehot_join", who, tiles, r_bitmaps, r_sizes,
                              s_bitmaps, s_sizes, lo, hi)
    TM, TN, _ = tiles
    device = r_bitmaps.device
    _build.check_operand(who, "skip", skip, (M // TM, N // TN), device,
                         torch.int32)
    out = torch.empty((M, N), dtype=torch.bool, device=device)
    if M == 0 or N == 0:
        return out
    r_bitmaps, s_bitmaps, W = _quad_words(r_bitmaps, s_bitmaps, W)
    p, q, code = _threshold(t, measure)
    err = _launchers()[0](
        r_bitmaps.data_ptr(), s_bitmaps.data_ptr(), r_sizes.data_ptr(),
        s_sizes.data_ptr(), lo.data_ptr(), hi.data_ptr(), skip.data_ptr(),
        M, N, W, TM, TN, code, p, q, out.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream)
    _build.check_launch(who, err)
    onehot_join_tiled.launches += 1
    return out


def onehot_join_live_tiled(tile_i, tile_j, r_bitmaps, r_sizes, s_bitmaps,
                           s_sizes, lo, hi, *, t: float,
                           measure: str = "jaccard", tiles=DEFAULT_TILES):
    """One-hot join over the live tiles only (K4); the contract of
    ``bitmap_join.bitmap_join_live_tiled``. Tile l's mask and count are
    written at index l, whatever order the CTAs take the tiles in
    (``cta_order``)."""
    who = "onehot_join_live_tiled"
    if _device_of(r_bitmaps, who) == "cpu":
        return onehot_join_live_tiled_ref(
            tile_i, tile_j, r_bitmaps, r_sizes, s_bitmaps, s_sizes, lo, hi,
            t=t, measure=measure, tiles=tiles)
    M, N, W = _check_operands("onehot_join", who, tiles, r_bitmaps, r_sizes,
                              s_bitmaps, s_sizes, lo, hi)
    TM, TN, _ = tiles
    device = r_bitmaps.device
    L = tile_i.shape[0]
    for name, x in (("tile_i", tile_i), ("tile_j", tile_j)):
        _build.check_operand(who, name, x, (L,), device, torch.int32)
    masks = torch.empty((L, TM, TN), dtype=torch.bool, device=device)
    counts = torch.zeros((L, 1), dtype=torch.int32, device=device)
    if L == 0:
        return masks, counts
    order = cta_order(tile_i, tile_j, M // TM)
    r_bitmaps, s_bitmaps, W = _quad_words(r_bitmaps, s_bitmaps, W)
    p, q, code = _threshold(t, measure)
    err = _launchers()[1](
        tile_i.data_ptr(), tile_j.data_ptr(), order.data_ptr(), L,
        r_bitmaps.data_ptr(), s_bitmaps.data_ptr(), r_sizes.data_ptr(),
        s_sizes.data_ptr(), lo.data_ptr(), hi.data_ptr(), N, W, TM, TN, code,
        p, q, masks.data_ptr(), counts.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream)
    _build.check_launch(who, err)
    onehot_join_live_tiled.launches += 1
    return masks, counts


onehot_join_tiled.launches = 0
onehot_join_live_tiled.launches = 0
