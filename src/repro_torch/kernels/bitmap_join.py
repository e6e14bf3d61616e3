"""The bitmap AND-popcount join over tiles (K2, K3), on a CUDA GPU.

The port of the JAX package's ``kernels/bitmap_join.py``. S membership is
packed 32 universe elements per uint32 word (held in int32 tensors with
the same bits); per (TM, TN) tile of the padded cell grid the
intersection sizes are ``sum_w popc(R[i][w] & S[j][w])``, and only the
measure predicate and the Lemma-3.1 column window leave the kernel: a
boolean mask, plus an exact pair count per live tile.

  * ``bitmap_join_tiled`` (K3) — every tile of the (M/TM, N/TN) grid,
    gated by a skip mask (tiles wholly outside every row's window stay
    all False), into the dense (M, N) mask;
  * ``bitmap_join_live_tiled`` (K2) — only the host-compacted live
    (i, j) tiles, into an (L, TM, TN) mask and (L, 1) counts.

Each wrapper runs its plain PyTorch version (``*_ref``) on CPU tensors
and launches the hand-written kernel of ``csrc/bitmap_join.cu`` on CUDA
tensors, counting the launch in ``<wrapper>.launches``. There is no
fallback from the CUDA path: a failed build or launch raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..core import measures
from ..core.tile_join import _popcount_qualify
from . import _build

__all__ = ["DEFAULT_TILES", "bitmap_join_tiled", "bitmap_join_live_tiled",
           "bitmap_join_tiled_ref", "bitmap_join_live_tiled_ref",
           "tiled_ref", "live_tiled_ref", "launch_tiled", "launch_live",
           "cta_order"]

#: (TM, TN, TW), the reference's; ``ops.pick_tiles`` shrinks them for
#: small operands
DEFAULT_TILES = (256, 256, 8)


# ---------------------------------------------------------------------- #
# plain PyTorch versions — the CPU path and the kernels' oracles
# ---------------------------------------------------------------------- #
def live_tiled_ref(qualify_fn, tile_i, tile_j, r_bitmaps, r_sizes,
                   s_bitmaps, s_sizes, lo, hi, *, t, measure, tiles):
    """The live-tile join of any counting method: per live tile (i, j),
    ``qualify_fn`` (the counts, the predicate and the window) over its TM
    R rows and TN S columns, the window shifted to the tile's columns.
    -> (mask (L, TM, TN) bool, counts (L, 1) int32)."""
    TM, TN, _ = tiles
    L = tile_i.shape[0]
    masks = torch.zeros((L, TM, TN), dtype=torch.bool,
                        device=r_bitmaps.device)
    for l, (i, j) in enumerate(zip(tile_i.tolist(), tile_j.tolist())):
        rows, cs = slice(i * TM, (i + 1) * TM), slice(j * TN, (j + 1) * TN)
        masks[l] = qualify_fn(r_bitmaps[rows], r_sizes[rows, 0],
                              s_bitmaps[cs], s_sizes[0, cs],
                              lo[rows, 0] - j * TN, hi[rows, 0] - j * TN,
                              t=t, measure=measure)
    return masks, masks.sum(dim=(1, 2), dtype=torch.int32).reshape(L, 1)


def tiled_ref(qualify_fn, r_bitmaps, r_sizes, s_bitmaps, s_sizes, lo, hi,
              skip, *, t, measure, tiles):
    """The dense tiled join of any counting method: ``live_tiled_ref``
    over every tile whose skip flag is 0, the skipped tiles all False."""
    TM, TN, _ = tiles
    M, N = r_bitmaps.shape[0], s_bitmaps.shape[0]
    ti, tj = torch.nonzero(skip == 0, as_tuple=True)
    masks, _ = live_tiled_ref(qualify_fn, ti, tj, r_bitmaps, r_sizes,
                              s_bitmaps, s_sizes, lo, hi, t=t,
                              measure=measure, tiles=tiles)
    out = torch.zeros((M // TM, N // TN, TM, TN), dtype=torch.bool,
                      device=r_bitmaps.device)
    out[ti, tj] = masks
    return out.permute(0, 2, 1, 3).reshape(M, N)


def bitmap_join_tiled_ref(r_bitmaps, r_sizes, s_bitmaps, s_sizes, lo, hi,
                          skip, *, t: float, measure: str = "jaccard",
                          tiles=DEFAULT_TILES):
    """Plain version of ``bitmap_join_tiled``: the reference's
    ``_popcount_qualify`` (popcount counts, predicate, window) on every
    tile that the skip mask keeps."""
    return tiled_ref(_popcount_qualify, r_bitmaps, r_sizes, s_bitmaps,
                     s_sizes, lo, hi, skip, t=t, measure=measure,
                     tiles=tiles)


def bitmap_join_live_tiled_ref(tile_i, tile_j, r_bitmaps, r_sizes,
                               s_bitmaps, s_sizes, lo, hi, *, t: float,
                               measure: str = "jaccard",
                               tiles=DEFAULT_TILES):
    """Plain version of ``bitmap_join_live_tiled``: ``_popcount_qualify``
    per live tile."""
    return live_tiled_ref(_popcount_qualify, tile_i, tile_j, r_bitmaps,
                          r_sizes, s_bitmaps, s_sizes, lo, hi, t=t,
                          measure=measure, tiles=tiles)


# ---------------------------------------------------------------------- #
# CUDA kernel wrappers (shared with the one-hot kernels, which take the
# same operands)
# ---------------------------------------------------------------------- #
#: kernel libraries whose live-tile entry point takes, after tile_j, the
#: order in which its CTAs take the live tiles (a permutation)
ORDERED_LIBS = ("onehot_join",)

#: kernel libraries that read each row's words in 16-byte pieces: the
#: word axis of their bitmaps is zero-padded to a multiple of 4 before a
#: launch (a copy; zero words add nothing to any count)
QUAD_WORD_LIBS = ("onehot_join",)

#: the (TM, TN) each kernel library takes: K2/K3 cut a tile into CTA
#: sub-tiles of min(TM, 64) rows x 64 columns; K4/K5 run one CTA per tile
#: of one or two 64-row warpgroups
TILE_RULES = {
    "bitmap_join": (lambda tm, tn: tn % 64 == 0 and tm >= 1
                    and (tm <= 64 or tm % 64 == 0),
                    "TN a multiple of 64 and TM <= 64 or a multiple of 64"),
    "onehot_join": (lambda tm, tn: 1 <= tm <= 128 and tn in (128, 256),
                    "1 <= TM <= 128 and TN in (128, 256)"),
}


@functools.cache
def _launchers(lib: str):
    """(tiled, live) C entry points of ``csrc/<lib>.cu``, built at first
    use (``kernels/_build.py``)."""
    so = _build.load(lib)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    tiled = getattr(so, f"{lib}_tiled_launch")
    # r, s, rsz, ssz, lo, hi, skip, M, N, W, tm, tn, measure, p, q, out,
    # stream
    tiled.argtypes = [ptr] * 7 + [i32] * 8 + [ptr, ptr]
    tiled.restype = i32
    live = getattr(so, f"{lib}_live_tiled_launch")
    # ti, tj, [order], L, r, s, rsz, ssz, lo, hi, N, W, tm, tn, measure, p,
    # q, mask, counts, stream
    live.argtypes = ([ptr] * (3 if lib in ORDERED_LIBS else 2) + [i32]
                     + [ptr] * 6 + [i32] * 7 + [ptr] * 3)
    live.restype = i32
    return tiled, live


def _check_operands(lib, who, tiles, r_bitmaps, r_sizes, s_bitmaps, s_sizes,
                    lo, hi):
    """Shapes of the padded operands -> (M, N, W); raises ``ValueError``
    on a tiling the kernels of ``lib`` do not take or an operand that is
    not an int32 contiguous tensor on the bitmaps' device."""
    TM, TN, TW = tiles
    M, W = r_bitmaps.shape
    N = s_bitmaps.shape[0]
    if M % TM or N % TN or W % TW:
        raise ValueError(f"{who}: operands ({M}, {N}, {W}) are not padded "
                         f"to the tiles {tuple(tiles)}")
    takes, rule = TILE_RULES[lib]
    if not takes(TM, TN):
        raise ValueError(f"{who}: the kernel takes {rule}, got "
                         f"{tuple(tiles)}")
    device = r_bitmaps.device
    for name, x, shape in (("r_bitmaps", r_bitmaps, (M, W)),
                           ("s_bitmaps", s_bitmaps, (N, W)),
                           ("r_sizes", r_sizes, (M, 1)),
                           ("s_sizes", s_sizes, (1, N)),
                           ("lo", lo, (M, 1)), ("hi", hi, (M, 1))):
        _build.check_operand(who, name, x, shape, device, torch.int32)
    return M, N, W


def _quad_words(lib, r_bitmaps, s_bitmaps, W):
    """The bitmaps as ``lib``'s kernels read them -> (r, s, W)."""
    pad = -W % 4 if lib in QUAD_WORD_LIBS else 0
    if pad:
        r_bitmaps, s_bitmaps = (torch.nn.functional.pad(x, (0, pad))
                                for x in (r_bitmaps, s_bitmaps))
    return r_bitmaps, s_bitmaps, W + pad


def launch_tiled(lib, who, r_bitmaps, r_sizes, s_bitmaps, s_sizes, lo, hi,
                 skip, *, t, measure, tiles):
    """Launch K3 or K5 (``lib``) on CUDA operands -> (launched, (M, N)
    bool mask); an empty grid launches nothing."""
    M, N, W = _check_operands(lib, who, tiles, r_bitmaps, r_sizes,
                              s_bitmaps, s_sizes, lo, hi)
    TM, TN, _ = tiles
    device = r_bitmaps.device
    _build.check_operand(who, "skip", skip, (M // TM, N // TN), device,
                         torch.int32)
    out = torch.empty((M, N), dtype=torch.bool, device=device)
    if M == 0 or N == 0:
        return False, out
    r_bitmaps, s_bitmaps, W = _quad_words(lib, r_bitmaps, s_bitmaps, W)
    p, q = measures.threshold_fraction(t)
    code = measures.MEASURE_CODES[measures.get_measure(measure).name]
    err = _launchers(lib)[0](
        r_bitmaps.data_ptr(), s_bitmaps.data_ptr(), r_sizes.data_ptr(),
        s_sizes.data_ptr(), lo.data_ptr(), hi.data_ptr(), skip.data_ptr(),
        M, N, W, TM, TN, code, p, q, out.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream)
    _build.check_launch(who, err)
    return True, out


def cta_order(tile_i: torch.Tensor, tile_j: torch.Tensor,
              m_tiles: int) -> torch.Tensor:
    """The order in which the CTAs of an ``ORDERED_LIBS`` kernel take the
    live tiles: column tile by column tile, row tiles ascending within
    each (one stable sort of ``tile_j * m_tiles + tile_i``), so the CTAs
    that run together share their S words in the L2 cache -> (L,) int32
    permutation of the tile indices, on their device."""
    key = tile_j.long() * m_tiles + tile_i.long()
    return torch.argsort(key, stable=True).to(torch.int32)


def launch_live(lib, who, tile_i, tile_j, r_bitmaps, r_sizes, s_bitmaps,
                s_sizes, lo, hi, *, t, measure, tiles):
    """Launch K2 or K4 (``lib``) on CUDA operands -> (launched, (mask
    (L, TM, TN) bool, counts (L, 1) int32)); no live tile launches
    nothing. A library of ``ORDERED_LIBS`` is also given ``cta_order``;
    tile l's outputs stay at index l."""
    M, N, W = _check_operands(lib, who, tiles, r_bitmaps, r_sizes,
                              s_bitmaps, s_sizes, lo, hi)
    TM, TN, _ = tiles
    device = r_bitmaps.device
    L = tile_i.shape[0]
    lead = [tile_i, tile_j]
    for name, x in zip(("tile_i", "tile_j"), lead):
        _build.check_operand(who, name, x, (L,), device, torch.int32)
    if lib in ORDERED_LIBS:
        lead.append(cta_order(tile_i, tile_j, M // TM))
    masks = torch.empty((L, TM, TN), dtype=torch.bool, device=device)
    counts = torch.zeros((L, 1), dtype=torch.int32, device=device)
    if L == 0:
        return False, (masks, counts)
    r_bitmaps, s_bitmaps, W = _quad_words(lib, r_bitmaps, s_bitmaps, W)
    p, q = measures.threshold_fraction(t)
    code = measures.MEASURE_CODES[measures.get_measure(measure).name]
    err = _launchers(lib)[1](
        *(x.data_ptr() for x in lead), L, r_bitmaps.data_ptr(),
        s_bitmaps.data_ptr(), r_sizes.data_ptr(), s_sizes.data_ptr(),
        lo.data_ptr(), hi.data_ptr(), N, W, TM, TN, code, p, q,
        masks.data_ptr(), counts.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream)
    _build.check_launch(who, err)
    return True, (masks, counts)


def _device_of(x: torch.Tensor, who: str) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{who}: no kernel for {x.device}")
    return x.device.type


def bitmap_join_tiled(r_bitmaps, r_sizes, s_bitmaps, s_sizes, lo, hi, skip,
                      *, t: float, measure: str = "jaccard",
                      tiles=DEFAULT_TILES) -> torch.Tensor:
    """Dense popcount join (K3); see ops.bitmap_join.

    Operands pre-padded to tile multiples, all int32: r_bitmaps (M, W),
    s_bitmaps (N, W) (uint32 bits), r_sizes/lo/hi (M, 1), s_sizes (1, N),
    skip (M/TM, N/TN). Returns the (M, N) bool mask on the operands'
    device. CPU tensors run the plain version; CUDA tensors launch the
    kernel on the current stream without synchronising.
    """
    if _device_of(r_bitmaps, "bitmap_join_tiled") == "cpu":
        return bitmap_join_tiled_ref(r_bitmaps, r_sizes, s_bitmaps, s_sizes,
                                     lo, hi, skip, t=t, measure=measure,
                                     tiles=tiles)
    launched, out = launch_tiled(
        "bitmap_join", "bitmap_join_tiled", r_bitmaps, r_sizes, s_bitmaps,
        s_sizes, lo, hi, skip, t=t, measure=measure, tiles=tiles)
    bitmap_join_tiled.launches += launched
    return out


def bitmap_join_live_tiled(tile_i, tile_j, r_bitmaps, r_sizes, s_bitmaps,
                           s_sizes, lo, hi, *, t: float,
                           measure: str = "jaccard", tiles=DEFAULT_TILES):
    """Popcount join over the live tiles only (K2); see
    ops.bitmap_join_pairs_dispatch.

    tile_i/tile_j (L,) int32 live-tile coordinates; the other operands
    as in ``bitmap_join_tiled``. Returns (mask (L, TM, TN) bool, counts
    (L, 1) int32) on the operands' device.
    """
    if _device_of(r_bitmaps, "bitmap_join_live_tiled") == "cpu":
        return bitmap_join_live_tiled_ref(
            tile_i, tile_j, r_bitmaps, r_sizes, s_bitmaps, s_sizes, lo, hi,
            t=t, measure=measure, tiles=tiles)
    launched, out = launch_live(
        "bitmap_join", "bitmap_join_live_tiled", tile_i, tile_j, r_bitmaps,
        r_sizes, s_bitmaps, s_sizes, lo, hi, t=t, measure=measure,
        tiles=tiles)
    bitmap_join_live_tiled.launches += launched
    return out


bitmap_join_tiled.launches = 0
bitmap_join_live_tiled.launches = 0
