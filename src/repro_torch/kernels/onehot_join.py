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
column tile (``bitmap_join.cta_order``), so the tiles that run together
share their S words in the L2 cache. The plain PyTorch
versions multiply float32 0/1 matrices in universe chunks (exact: every
partial count is an integer below 2^24, and 0 and 1 survive TF32's
rounding of the inputs). Wrappers take the plain version on CPU tensors
only, launch the kernel on CUDA tensors and count the launch in
``<wrapper>.launches``; there is no fallback.
"""
from __future__ import annotations

import torch

from ..core.tile_join import qualify, stage_budget
from .bitmap_join import (_device_of, launch_live, launch_tiled,
                          live_tiled_ref, tiled_ref)

__all__ = ["DEFAULT_TILES", "membership_counts",
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
def onehot_join_tiled(r_bitmaps, r_sizes, s_bitmaps, s_sizes, lo, hi, skip,
                      *, t: float, measure: str = "jaccard",
                      tiles=DEFAULT_TILES) -> torch.Tensor:
    """Dense one-hot join (K5); the contract of
    ``bitmap_join.bitmap_join_tiled``."""
    if _device_of(r_bitmaps, "onehot_join_tiled") == "cpu":
        return onehot_join_tiled_ref(r_bitmaps, r_sizes, s_bitmaps, s_sizes,
                                     lo, hi, skip, t=t, measure=measure,
                                     tiles=tiles)
    launched, out = launch_tiled(
        "onehot_join", "onehot_join_tiled", r_bitmaps, r_sizes, s_bitmaps,
        s_sizes, lo, hi, skip, t=t, measure=measure, tiles=tiles)
    onehot_join_tiled.launches += launched
    return out


def onehot_join_live_tiled(tile_i, tile_j, r_bitmaps, r_sizes, s_bitmaps,
                           s_sizes, lo, hi, *, t: float,
                           measure: str = "jaccard", tiles=DEFAULT_TILES):
    """One-hot join over the live tiles only (K4); the contract of
    ``bitmap_join.bitmap_join_live_tiled``. Tile l's mask and count are
    written at index l, whatever order the CTAs take the tiles in."""
    if _device_of(r_bitmaps, "onehot_join_live_tiled") == "cpu":
        return onehot_join_live_tiled_ref(
            tile_i, tile_j, r_bitmaps, r_sizes, s_bitmaps, s_sizes, lo, hi,
            t=t, measure=measure, tiles=tiles)
    launched, out = launch_live(
        "onehot_join", "onehot_join_live_tiled", tile_i, tile_j, r_bitmaps,
        r_sizes, s_bitmaps, s_sizes, lo, hi, t=t, measure=measure,
        tiles=tiles)
    onehot_join_live_tiled.launches += launched
    return out


onehot_join_tiled.launches = 0
onehot_join_live_tiled.launches = 0
