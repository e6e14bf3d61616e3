"""Plain PyTorch oracles for the bitmap and one-hot join kernels.

The port of the JAX package's ``kernels/ref.py``. Both kernel families
compute one function: given R/S membership bitmaps, sizes, per-row
column windows and a threshold, the (m, n) bool matrix of qualifying
pairs (Jaccard >= t, column inside the Lemma-3.1 window). These oracles
keep the reference's float32 predicate ``f * (1 + t) >= t * (|r| +
|s|)``, ``counts > 0`` and the window, not the integer-exact predicate
of the kernels (``core.measures.device_qualify``): they are the
reference's contract, as it states it.
"""
from __future__ import annotations

import torch

from ..core.tile_join import popcount_counts

__all__ = ["join_ref", "counts_ref"]


def _words(bitmaps: torch.Tensor) -> torch.Tensor:
    """uint32 words as the port holds them: int32, the same bits."""
    return (bitmaps.view(torch.int32) if bitmaps.dtype == torch.uint32
            else bitmaps)


def counts_ref(r_bitmaps: torch.Tensor,
               s_bitmaps: torch.Tensor) -> torch.Tensor:
    """(m, W) x (n, W) uint32 (or int32-held) words -> (m, n) int32
    intersection sizes."""
    return popcount_counts(_words(r_bitmaps), _words(s_bitmaps))


def join_ref(r_bitmaps, r_sizes, s_bitmaps, s_sizes, lo, hi,
             t: float) -> torch.Tensor:
    """Oracle for the bitmap_join / onehot_join kernels -> (m, n) bool."""
    counts = counts_ref(r_bitmaps, s_bitmaps)
    f = counts.to(torch.float32)
    rhs = t * (r_sizes[:, None] + s_sizes[None, :]).to(torch.float32)
    cols = torch.arange(s_bitmaps.shape[0], dtype=torch.int32,
                        device=counts.device)[None, :]
    in_window = (cols >= lo[:, None]) & (cols < hi[:, None])
    return (f * (1.0 + t) >= rhs) & (counts > 0) & in_window
