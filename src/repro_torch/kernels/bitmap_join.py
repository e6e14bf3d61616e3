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
and launches the hand-written kernels of ``csrc/bitmap_join.cu`` on CUDA
tensors, counting the launch in ``<wrapper>.launches``. The kernels visit
only the words that hold a member: S's nonzero words come compressed
(``compress_s``, the optional ``s_sparse`` operand, which the join
driver builds once per S and caches; a call without it builds it), and
each tile's rows are taken 16 at a time in window order
(``window_order``). There is no fallback from the CUDA path: a failed
build or launch, or an operand the kernels do not take, raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..core import measures
from ..core.tile_join import _popcount_qualify
from . import _build

__all__ = ["DEFAULT_TILES", "bitmap_join_tiled", "bitmap_join_live_tiled",
           "bitmap_join_tiled_ref", "bitmap_join_live_tiled_ref",
           "tiled_ref", "live_tiled_ref", "SparseWords", "compress_s",
           "window_order", "sparse_smem_bytes", "GROUP_ROWS", "UNION_SLICE",
           "MAX_WORDS"]

#: (TM, TN, TW), the reference's; ``ops.pick_tiles`` shrinks them for
#: small operands
DEFAULT_TILES = (256, 256, 8)
#: rows a K2/K3 CTA takes together, and the union words it stages in
#: shared memory at a time (``kGroup``, ``kSlice`` of csrc/bitmap_join.cu)
GROUP_ROWS = 16
UNION_SLICE = 512
#: shared memory a K2/K3 CTA may ask for: the card's 232 448 bytes a
#: block, less the kernel's room for its static shared memory
_SMEM_LIMIT = 232448 - 1024


def sparse_smem_bytes(words: int) -> int:
    """Dynamic shared memory of a K2/K3 join CTA at ``words`` words (the
    library's ``bitmap_join_smem_bytes``): a slice of the union (16 row
    words and a word index a slot) and the word -> slot map (W 16-bit
    entries)."""
    return min(words, UNION_SLICE) * (4 * GROUP_ROWS + 4) + (
        (2 * words + 15) & ~15)


#: the widest bitmap K2/K3 take, in words (98 304: a universe of 3.1 M);
#: wider operands raise ``ValueError`` before a launch
MAX_WORDS = (_SMEM_LIMIT - UNION_SLICE * (4 * GROUP_ROWS + 4)) // 2


class SparseWords(NamedTuple):
    """S's nonzero words, as K2/K3 read them (``compress_s``).

    Column c's k-th nonzero word (ascending word index) is the pair
    ``pairs[offsets[c // 32] + 32 * k + c % 32]`` = (word index, word
    bits as int32), for k < ``counts[c]``: the columns come in slabs of
    32, slot-major, so the 32 columns of a warp read their k-th pairs
    with one coalesced load. Slab b holds 32 x the largest count of its
    columns slots; a slot past its column's count is (0, 0)."""

    counts: torch.Tensor   # (Nc,) int32, Nc = the columns rounded up to 32
    offsets: torch.Tensor  # (Nc / 32 + 1,) int64: each slab's first slot
    pairs: torch.Tensor    # (offsets[-1], 2) int32
    words: int             # the word width of the sheet it was built from


def compress_s(s_bitmaps: torch.Tensor) -> SparseWords:
    """(N, W) int32-held bitmap sheet -> its ``SparseWords``, on the
    sheet's device (one host sync: the pair count sizes the buffer)."""
    n, w = s_bitmaps.shape
    device = s_bitmaps.device
    nz = s_bitmaps != 0
    counts = torch.zeros(-(-n // 32) * 32, dtype=torch.int32, device=device)
    counts[:n] = nz.sum(1, dtype=torch.int32)
    offsets = torch.zeros(counts.shape[0] // 32 + 1, dtype=torch.int64,
                          device=device)
    torch.cumsum(counts.view(-1, 32).amax(1).long() * 32, 0,
                 out=offsets[1:])
    col, word = torch.nonzero(nz, as_tuple=True)  # column-major, ascending
    first = torch.cumsum(counts.long(), 0) - counts  # column c's first pair
    rank = torch.arange(col.shape[0], device=device) - first[col]
    at = offsets[col // 32] + 32 * rank + col % 32
    pairs = torch.zeros((int(offsets[-1]), 2), dtype=torch.int32,
                        device=device)
    pairs[at, 0] = word.to(torch.int32)
    pairs[at, 1] = s_bitmaps[col, word]
    return SparseWords(counts, offsets, pairs, w)


def window_order(lo: torch.Tensor, hi: torch.Tensor, tm: int) -> torch.Tensor:
    """The row order K2/K3 take: inside each ``tm``-row tile the rows by
    window start (stable), rows with an empty window last, so 16
    consecutive rows have close windows; no row leaves its tile ->
    (M,) int32 permutation on the windows' device (one ``argsort``)."""
    lo, hi = lo.reshape(-1).long(), hi.reshape(-1).long()
    tile = torch.arange(lo.shape[0], device=lo.device) // tm
    key = (tile << 32) | torch.where(lo < hi, lo, 2 ** 31)
    return torch.argsort(key, stable=True).to(torch.int32)


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
# CUDA kernel wrappers. The operand checks are shared with the one-hot
# kernels (K4, K5), which take the same operands.
# ---------------------------------------------------------------------- #
#: the (TM, TN) each kernel library takes: K2/K3 run a CTA per 16-row
#: group of a tile whose columns start on a 32-column slab of the
#: compressed S; K4/K5 run one CTA per tile of one or two 64-row
#: warpgroups
TILE_RULES = {
    "bitmap_join": (lambda tm, tn: tn % 32 == 0 and tm >= 1 and tn >= 32,
                    "TN a multiple of 32"),
    "onehot_join": (lambda tm, tn: 1 <= tm <= 128 and tn in (128, 256),
                    "1 <= TM <= 128 and TN in (128, 256)"),
}


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


@functools.cache
def _launchers():
    """(tiled, live) C entry points of ``csrc/bitmap_join.cu`` (K3, K2),
    built at first use."""
    so = _build.load("bitmap_join")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    tiled = so.bitmap_join_tiled_launch
    # r, rsz, ssz, lo, hi, skip, order, s_counts, s_off, s_pairs, u_idx,
    # u_words, u_count, M, N, W, tm, tn, measure, p, q, out, stream
    tiled.argtypes = [ptr] * 13 + [i32] * 8 + [ptr, ptr]
    tiled.restype = i32
    live = so.bitmap_join_live_tiled_launch
    # ti, tj, L, r, rsz, ssz, lo, hi, order, s_counts, s_off, s_pairs,
    # u_idx, u_words, u_count, M, N, W, tm, tn, measure, p, q, mask,
    # counts, stream
    live.argtypes = [ptr, ptr, i32] + [ptr] * 12 + [i32] * 8 + [ptr] * 3
    live.restype = i32
    return tiled, live


def _check_sparse(who, s_sparse, N, W, device):
    """Raise ``ValueError`` unless ``s_sparse`` is a ``SparseWords`` on
    ``device`` that covers the N columns of a W-word sheet."""
    if not isinstance(s_sparse, SparseWords):
        raise ValueError(f"{who}: s_sparse must be a SparseWords "
                         f"(compress_s), got {type(s_sparse).__name__}")
    nc = s_sparse.counts.shape[0]
    if nc < N or nc % 32 or s_sparse.words > W:
        raise ValueError(f"{who}: s_sparse holds {nc} columns of "
                         f"{s_sparse.words} words; the operands have {N} "
                         f"columns of {W} words")
    _build.check_operand(who, "s_sparse.counts", s_sparse.counts, (nc,),
                         device, torch.int32)
    _build.check_operand(who, "s_sparse.offsets", s_sparse.offsets,
                         (nc // 32 + 1,), device, torch.int64)
    _build.check_operand(who, "s_sparse.pairs", s_sparse.pairs,
                         (s_sparse.pairs.shape[0], 2), device, torch.int32)


def _launch_sparse(who, lead, r_bitmaps, r_sizes, s_bitmaps, s_sizes, lo,
                   hi, skip, *, t, measure, tiles, s_sparse):
    """Launch K3 (``lead`` None) or K2 (``lead`` the live tiles) on CUDA
    operands -> (launched, output): K3's (M, N) mask, or K2's (mask
    (L, TM, TN), counts (L, 1)). An empty grid launches nothing."""
    M, N, W = _check_operands("bitmap_join", who, tiles, r_bitmaps,
                              r_sizes, s_bitmaps, s_sizes, lo, hi)
    TM, TN, _ = tiles
    device = r_bitmaps.device
    if lead is None:
        _build.check_operand(who, "skip", skip, (M // TM, N // TN), device,
                             torch.int32)
        out = torch.empty((M, N), dtype=torch.bool, device=device)
        empty = M == 0 or N == 0
    else:
        L = lead[0].shape[0]
        for name, x in zip(("tile_i", "tile_j"), lead):
            _build.check_operand(who, name, x, (L,), device, torch.int32)
        out = (torch.empty((L, TM, TN), dtype=torch.bool, device=device),
               torch.zeros((L, 1), dtype=torch.int32, device=device))
        empty = L == 0
    if W > MAX_WORDS:
        raise ValueError(f"{who}: {W} words a bitmap; the kernel's word -> "
                         f"slot map takes at most MAX_WORDS = {MAX_WORDS}")
    if empty:
        return False, out
    if s_sparse is None:
        s_sparse = compress_s(s_bitmaps)
    _check_sparse(who, s_sparse, N, W, device)
    order = window_order(lo, hi, TM)
    n_groups = M // TM * -(-TM // GROUP_ROWS)
    u_idx = torch.empty((n_groups, W), dtype=torch.int32, device=device)
    u_words = torch.empty((n_groups, W, GROUP_ROWS), dtype=torch.int32,
                          device=device)
    u_count = torch.empty(n_groups, dtype=torch.int32, device=device)
    p, q = measures.threshold_fraction(t)
    code = measures.MEASURE_CODES[measures.get_measure(measure).name]
    operands = (r_bitmaps.data_ptr(), r_sizes.data_ptr(), s_sizes.data_ptr(),
                lo.data_ptr(), hi.data_ptr())
    shared = (order.data_ptr(), s_sparse.counts.data_ptr(),
              s_sparse.offsets.data_ptr(), s_sparse.pairs.data_ptr(),
              u_idx.data_ptr(), u_words.data_ptr(), u_count.data_ptr(), M, N,
              W, TM, TN, code, p, q)
    stream = torch.cuda.current_stream(device).cuda_stream
    tiled, live = _launchers()
    if lead is None:
        err = tiled(*operands, skip.data_ptr(), *shared, out.data_ptr(),
                    stream)
    else:
        err = live(lead[0].data_ptr(), lead[1].data_ptr(), L, *operands,
                   *shared, out[0].data_ptr(), out[1].data_ptr(), stream)
    _build.check_launch(who, err)
    return True, out


def _device_of(x: torch.Tensor, who: str) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{who}: no kernel for {x.device}")
    return x.device.type


def bitmap_join_tiled(r_bitmaps, r_sizes, s_bitmaps, s_sizes, lo, hi, skip,
                      *, t: float, measure: str = "jaccard",
                      tiles=DEFAULT_TILES,
                      s_sparse: SparseWords | None = None) -> torch.Tensor:
    """Dense popcount join (K3); see ops.bitmap_join.

    Operands pre-padded to tile multiples, all int32: r_bitmaps (M, W),
    s_bitmaps (N, W) (uint32 bits), r_sizes/lo/hi (M, 1), s_sizes (1, N),
    skip (M/TM, N/TN). ``s_sparse`` is ``compress_s`` of s_bitmaps (or of
    a sheet that holds it as its first N rows); the kernels read S only
    through it, and a CUDA call without it builds it. Returns the (M, N)
    bool mask on the operands' device. CPU tensors run the plain version;
    CUDA tensors launch the kernels on the current stream without
    synchronising.
    """
    if _device_of(r_bitmaps, "bitmap_join_tiled") == "cpu":
        return bitmap_join_tiled_ref(r_bitmaps, r_sizes, s_bitmaps, s_sizes,
                                     lo, hi, skip, t=t, measure=measure,
                                     tiles=tiles)
    launched, out = _launch_sparse(
        "bitmap_join_tiled", None, r_bitmaps, r_sizes, s_bitmaps, s_sizes,
        lo, hi, skip, t=t, measure=measure, tiles=tiles, s_sparse=s_sparse)
    bitmap_join_tiled.launches += launched
    return out


def bitmap_join_live_tiled(tile_i, tile_j, r_bitmaps, r_sizes, s_bitmaps,
                           s_sizes, lo, hi, *, t: float,
                           measure: str = "jaccard", tiles=DEFAULT_TILES,
                           s_sparse: SparseWords | None = None):
    """Popcount join over the live tiles only (K2); see
    ops.bitmap_join_pairs_dispatch.

    tile_i/tile_j (L,) int32 live-tile coordinates; the other operands
    as in ``bitmap_join_tiled``. Returns (mask (L, TM, TN) bool, counts
    (L, 1) int32) on the operands' device; tile l's at index l.
    """
    if _device_of(r_bitmaps, "bitmap_join_live_tiled") == "cpu":
        return bitmap_join_live_tiled_ref(
            tile_i, tile_j, r_bitmaps, r_sizes, s_bitmaps, s_sizes, lo, hi,
            t=t, measure=measure, tiles=tiles)
    launched, out = _launch_sparse(
        "bitmap_join_live_tiled", (tile_i, tile_j), r_bitmaps, r_sizes,
        s_bitmaps, s_sizes, lo, hi, None, t=t, measure=measure, tiles=tiles,
        s_sparse=s_sparse)
    bitmap_join_live_tiled.launches += launched
    return out


bitmap_join_tiled.launches = 0
bitmap_join_live_tiled.launches = 0
