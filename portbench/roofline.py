"""The join kernels' least times, counted from the inputs.

Frozen copies of the H100's published peaks (NVIDIA's data sheet, SXM,
dense, at its 700 W limit) and of the operation counts of each kernel
family, so that the roofline shares the benchmark reports cannot move
with the program. A launch's bound is the larger of two times:

* bytes: the inputs' element ids and sizes read once (the R block's and
  the whole of S's), plus the pairs written once (8 bytes a pair), at the
  HBM rate;
* operations, per family (a walk, a popcount, a one-hot product):

  - walk (K1): 2 x lane steps + in-window steps + 4 x in-window cells, at
    the int32 rate. A lane is an element of an R row walking the S rows
    that hold it, largest row index first: it steps once per row at or
    past the row's window start lo, plus once onto the first row before
    lo; its in-window steps are the rows inside [lo, hi);
  - popcount (K2, K3): 3 x the words nonzero on both sides summed over the
    in-window cells, at the int32 rate;
  - one-hot (K4, K5): 2 x in-window cells x the universe's bits rounded
    up to words, at the int8 tensor-core rate.

The windows are Lemma 3.1's for Jaccard, worked out here from the sizes:
ceil(t |r|) <= |s| <= floor(|r| / t), over S sorted by (size descending,
id ascending). Nothing is read from the kernel's operand buffers, its
tiles or its padding.
"""
from __future__ import annotations

import numpy as np
import torch

from .reference import threshold_ratio

__all__ = ["HBM_BYTES_PER_S", "INT32_OPS_PER_S", "INT8_OPS_PER_S",
           "SortedS", "windows", "block_bounds"]

HBM_BYTES_PER_S = 3.35e12
# the data sheet's 67 TFLOP/s of float32 counts an FMA as two operations
# on 128 float32 lanes an SM; Hopper has 64 int32 lanes an SM, one
# operation each
INT32_OPS_PER_S = 67e12 / 4
INT8_OPS_PER_S = 1979e12


class SortedS:
    """S in (size descending, id ascending) order, with what the counts
    need: sizes, each element's rows (ascending), the nonzero words."""

    def __init__(self, s_off: np.ndarray, s_val: np.ndarray, universe: int):
        sizes = np.diff(s_off)
        self.order = np.lexsort((np.arange(len(sizes)), -sizes))
        self.sizes = sizes[self.order]
        self.universe = universe
        self.n = len(sizes)
        self.elements = int(s_off[-1])
        # element -> its rows in the sorted order, ascending: a sorted key
        rank = np.empty(self.n, np.int64)
        rank[self.order] = np.arange(self.n)
        rows = np.repeat(rank, sizes)
        self.key = np.sort(s_val.astype(np.int64) * (self.n + 1) + rows)
        self.count = np.bincount(s_val, minlength=universe).astype(np.int64)
        self.s_off, self.s_val = s_off, s_val
        self._tables: dict = {}

    def tables(self, device):
        """(sorted key, element counts) as int64 tensors on ``device``."""
        got = self._tables.get(str(device))
        if got is None:
            got = (torch.from_numpy(self.key).to(device),
                   torch.from_numpy(self.count).to(device))
            self._tables[str(device)] = got
        return got

    def words(self, device) -> torch.Tensor:
        """(n, W) float16 0/1: the sorted S's words that hold a member."""
        w = (self.universe + 31) // 32
        rows = torch.from_numpy(np.repeat(
            np.argsort(self.order), np.diff(self.s_off))).to(device)
        cols = torch.from_numpy(self.s_val.astype(np.int64) // 32).to(device)
        out = torch.zeros((self.n, w), dtype=torch.float16, device=device)
        out[rows, cols] = 1
        return out


def windows(r_sizes: np.ndarray, s: SortedS, t: float):
    """Lemma 3.1's column window [lo, hi) of each R row over the sorted S."""
    p, q = threshold_ratio(t)
    r = np.asarray(r_sizes, np.int64)
    lo_size = (p * r + q - 1) // q     # ceil(t |r|)
    hi_size = (q * r) // p             # floor(|r| / t)
    asc = s.sizes[::-1]
    lo = s.n - np.searchsorted(asc, hi_size, side="right")
    hi = s.n - np.searchsorted(asc, lo_size, side="left")
    return lo, np.maximum(hi, lo)


def _walk_ops(r_off, r_val, rows, lo, hi, s: SortedS, device) -> int:
    """2 x lane steps + in-window steps + 4 x in-window cells of rows,
    the lanes' row ranks looked up in S's sorted key on ``device``."""
    key, count = s.tables(device)
    lens = r_off[rows + 1] - r_off[rows]
    idx = (np.repeat(r_off[rows] - (np.cumsum(lens) - lens), lens)
           + np.arange(int(lens.sum()), dtype=np.int64))
    a = torch.from_numpy(r_val[idx].astype(np.int64)).to(device)
    row_lo = torch.from_numpy(np.repeat(lo, lens)).to(device)
    row_hi = torch.from_numpy(np.repeat(hi, lens)).to(device)
    ln = count[a]
    # a row whose window is empty needs no walk
    live = (ln > 0) & (row_hi > row_lo)
    a, ln, row_lo, row_hi = a[live], ln[live], row_lo[live], row_hi[live]
    base = a * (s.n + 1)
    below_lo = (torch.searchsorted(key, base + row_lo)
                - torch.searchsorted(key, base))
    below_hi = (torch.searchsorted(key, base + row_hi)
                - torch.searchsorted(key, base))
    lane = torch.minimum(ln, ln - below_lo + 1)
    win = (below_hi - below_lo).clamp(min=0)
    cells = int((hi - lo).sum())
    return int(2 * lane.sum() + win.sum()) + 4 * cells


def _popcount_ops(r_off, r_val, rows, lo, hi, s: SortedS, s_words) -> int:
    """3 x the words nonzero on both sides over the in-window cells."""
    device = s_words.device
    w = s_words.shape[1]
    lens = r_off[rows + 1] - r_off[rows]
    r = torch.from_numpy(np.repeat(np.arange(len(rows)), lens)).to(device)
    idx = (np.repeat(r_off[rows] - (np.cumsum(lens) - lens), lens)
           + np.arange(int(lens.sum()), dtype=np.int64))
    c = torch.from_numpy(r_val[idx].astype(np.int64) // 32).to(device)
    rw = torch.zeros((len(rows), w), dtype=torch.float16, device=device)
    rw[r, c] = 1
    total = 0
    # rows in window order, 128 at a time: each takes the columns that
    # its rows' windows span
    order = np.argsort(lo, kind="stable")
    for k in range(0, len(rows), 128):
        sel = order[k:k + 128]
        a, b = int(lo[sel].min()), int(hi[sel].max())
        if b <= a:
            continue
        # entries are word counts <= W < 2048: exact in float16
        both = (rw[torch.from_numpy(sel).to(device)]
                @ s_words[a:b].T).to(torch.int32)
        cols = torch.arange(a, b, device=device)[None, :]
        lo_t = torch.from_numpy(lo[sel]).to(device)[:, None]
        hi_t = torch.from_numpy(hi[sel]).to(device)[:, None]
        both *= (cols >= lo_t) & (cols < hi_t)
        total += int(both.sum(dtype=torch.int64))
    return 3 * total


def block_bounds(family: str, r_off, r_val, rows, pairs: int, s: SortedS,
                 t: float, device, s_words=None):
    """(bound s, bytes, operations) of one launch over the R rows ``rows``
    (one driver block) writing ``pairs`` pairs, or None for a family
    whose work is not counted here. The counts run on ``device``; the
    popcount family needs ``s_words`` (``SortedS.words``)."""
    rows = np.asarray(rows, np.int64)
    lens = r_off[rows + 1] - r_off[rows]
    moved = (4 * (int(lens.sum()) + len(rows)) + 4 * (s.elements + s.n)
             + 8 * pairs)
    lo, hi = windows(lens, s, t)
    if family == "walk":
        ops = _walk_ops(r_off, r_val, rows, lo, hi, s, device)
        peak = INT32_OPS_PER_S
    elif family == "popcount":
        ops = _popcount_ops(r_off, r_val, rows, lo, hi, s, s_words)
        peak = INT32_OPS_PER_S
    elif family == "onehot":
        bits = 32 * ((s.universe + 31) // 32)
        ops, peak = 2 * int((hi - lo).sum()) * bits, INT8_OPS_PER_S
    else:
        return None
    return max(moved / HBM_BYTES_PER_S, ops / peak), moved, ops
