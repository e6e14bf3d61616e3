"""The plain reference join, and the control that breaks its guarantee.

``pairs`` is an exact Jaccard R-S join written from the definition and
nothing of the program: each set is a row of a 0/1 membership matrix over
the universe, one matrix product gives every intersection size, and a pair
qualifies when ``|r & s| * q >= p * |r | s|`` in integers, ``p / q`` being
the threshold as the decimal it is written as (0.8 = 4/5), the boundary
included. It takes the raw sets that the benchmark made, never what the
program derived from them.

The product is exact: the entries are 0 and 1 and every sum is an
intersection size, at most the longer set's length (``product_dtype``).
On the card, where no set is longer than 2048, the factors are float16
with float32 accumulation (reduced-precision reduction held off) and the
product comes back in float16, which holds every integer up to 2048
exactly; with longer sets they are float32 with TF32 held off, exact up
to 2**24. On the CPU they are float32.

``keep`` turns the reference into the control: both sides are restricted
to the same seeded half of the universe, a coordinated sampling sketch of
Jaccard like MinHash's (the same hash on both sides). It is the
approximate join that near-duplicate detection often runs in place of the
exact one, and it breaks the configuration's guarantee that the answer is
exact.
"""
from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

__all__ = ["threshold_ratio", "product_dtype", "onehot", "pairs",
           "sketch_keep", "compare"]

#: the largest integer that float16 holds exactly, as all below it
FLOAT16_EXACT = 2048


def threshold_ratio(t: float) -> tuple[int, int]:
    """``t`` as the decimal it is written as, in lowest terms (0.8 -> 4/5)."""
    fr = Fraction(repr(float(t)))
    return fr.numerator, fr.denominator


def product_dtype(longest: int, device) -> torch.dtype:
    """The factors' type of an exact membership product whose longest set
    has ``longest`` elements: float16 on the card while every
    intersection fits in it, float32 otherwise."""
    if torch.device(device).type == "cuda" and longest <= FLOAT16_EXACT:
        return torch.float16
    return torch.float32


def onehot(off: np.ndarray, val: np.ndarray, rows, universe: int,
           dtype, device, keep=None):
    """The 0/1 membership matrix (len(rows), universe) of the sets
    ``rows`` of a flat collection, and their sizes (int32), both
    restricted to the elements where ``keep`` is True when given."""
    rows = np.asarray(rows, np.int64)
    lens = off[rows + 1] - off[rows]
    idx = (np.repeat(off[rows], lens)
           + np.arange(int(lens.sum()), dtype=np.int64)
           - np.repeat(np.cumsum(lens) - lens, lens))
    r = torch.from_numpy(np.repeat(np.arange(len(rows)), lens)).to(device)
    c = torch.from_numpy(val[idx].astype(np.int64)).to(device)
    if keep is not None:
        sel = keep[c]
        r, c = r[sel], c[sel]
    mat = torch.zeros((len(rows), universe), dtype=dtype, device=device)
    mat[r, c] = 1
    sizes = torch.bincount(r, minlength=len(rows)).to(torch.int32)
    return mat, sizes


def pairs(r_flat, r_rows, s_flat, universe: int, t: float, device,
          keep=None, s_chunk: int = 8192) -> set:
    """Every (i, j) with Jaccard(R row ``r_rows[i]``, S row j) >= t: R is
    the rows ``r_rows`` of the flat collection ``r_flat``, S the whole of
    ``s_flat`` (each an ``(offsets, values)`` pair). With ``keep`` (a bool
    tensor over the universe), the sketch of the control instead."""
    device = torch.device(device)
    p, q = threshold_ratio(t)
    r_off, s_off = r_flat[0], s_flat[0]
    rows = np.asarray(r_rows, np.int64)
    longest = int(max(np.max(r_off[rows + 1] - r_off[rows], initial=0),
                      np.max(np.diff(s_off), initial=0)))
    dtype = product_dtype(longest, device)
    matmul = torch.backends.cuda.matmul
    reduced, tf32 = (matmul.allow_fp16_reduced_precision_reduction,
                     matmul.allow_tf32)
    matmul.allow_fp16_reduced_precision_reduction = False
    matmul.allow_tf32 = False
    try:
        rm, r_sz = onehot(*r_flat, r_rows, universe, dtype, device, keep)
        n = len(s_flat[0]) - 1
        out = set()
        for a in range(0, n, s_chunk):
            b = min(a + s_chunk, n)
            sm, s_sz = onehot(*s_flat, np.arange(a, b), universe, dtype,
                              device, keep)
            inter = (rm @ sm.T).to(torch.int32)
            union = r_sz[:, None] + s_sz[None, :] - inter
            hit = (inter > 0) & (inter * q >= p * union)
            got = torch.nonzero(hit).cpu().numpy()
            out.update(zip(got[:, 0].tolist(), (got[:, 1] + a).tolist()))
            del sm, inter, union, hit
    finally:
        matmul.allow_fp16_reduced_precision_reduction = reduced
        matmul.allow_tf32 = tf32
    return out


def sketch_keep(universe: int, seed: int, device) -> torch.Tensor:
    """The control's seeded half of the universe (bool, on ``device``)."""
    gen = torch.Generator(device="cpu").manual_seed(int(seed) % 2 ** 63)
    return (torch.rand(universe, generator=gen) < 0.5).to(device)


def compare(got: set, want: set) -> tuple[int, int]:
    """-> (pairs of ``want`` missing from ``got``, pairs of ``got`` not in
    ``want``)."""
    return len(want - got), len(got - want)
