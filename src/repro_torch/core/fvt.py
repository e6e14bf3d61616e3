"""Reference Filter-and-Verification Trees (FVT / LFVT) — paper §3.1–3.2.

This is the faithful, pointer-based host implementation (a numpy copy of
the JAX package's ``core/fvt.py``) used as the oracle for every device
path. The device adaptation lives in ``core/lfvt_flat.py`` /
``core/tile_join.py`` / ``kernels/`` (see DESIGN.md §2 for the mapping).

Construction follows the paper exactly:
  Step 1  reorganize the collection into ``seq(a)`` = ordered (set id, size)
          2-tuples, size-descending (ties: id ascending, as in Fig. 2c).
  Step 2  insert each ``seq(a)`` as a root path into a prefix tree; the
          element table maps ``a -> (|seq(a)|, L(a))`` with ``L(a)`` the
          deepest node of the path.

The LFVT path-compresses non-branching runs into nodes holding a *sequence*
of 2-tuples (paper Fig. 3), with node splitting on partial prefix matches.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .sets import SetCollection

__all__ = ["FVT", "LFVT", "build_seqs"]


def build_seqs(S: SetCollection) -> dict[int, list[tuple[int, int]]]:
    """Paper Step 1: ``a -> seq(a)`` with (size desc, id asc) ordering.

    Works on original (unsorted) collections; the returned 2-tuples use the
    collection's external ids.
    """
    sizes = S.sizes()
    seqs: dict[int, list[tuple[int, int]]] = {}
    # iterate rows in (size desc, id asc) order so seq lists come out sorted
    order = np.lexsort((S.ids, -sizes))
    for row in order:
        sid, sz = int(S.ids[row]), int(sizes[row])
        for a in S.sets[row]:
            seqs.setdefault(int(a), []).append((sid, sz))
    return seqs


# ---------------------------------------------------------------------- #
# FVT
# ---------------------------------------------------------------------- #
@dataclasses.dataclass
class FVTNode:
    set_id: int
    size: int
    parent: Optional["FVTNode"]
    children: dict  # (set_id, size) -> FVTNode

    def __hash__(self):  # identity hashing: nodes are unique tree positions
        return id(self)


class FVT:
    """Filter-and-Verification Tree over a collection ``S`` (paper §3.1.1)."""

    def __init__(self, S: SetCollection):
        self.root = FVTNode(-1, 0, None, {})
        self.element_table: dict[int, tuple[int, FVTNode]] = {}
        self.n_nodes = 0
        self._build(S)

    def _build(self, S: SetCollection) -> None:
        for a, seq in build_seqs(S).items():
            node = self.root
            for sid, sz in seq:
                key = (sid, sz)
                nxt = node.children.get(key)
                if nxt is None:
                    nxt = FVTNode(sid, sz, node, {})
                    node.children[key] = nxt
                    self.n_nodes += 1
                node = nxt
            self.element_table[a] = (len(seq), node)

    # -------------------------------------------------------------- #
    def walk(self, a: int):
        """Yield (set_id, size) from L(a) to the root (exclusive)."""
        entry = self.element_table.get(a)
        if entry is None:
            return
        node = entry[1]
        while node is not self.root:
            yield node.set_id, node.size
            node = node.parent


# ---------------------------------------------------------------------- #
# LFVT
# ---------------------------------------------------------------------- #
@dataclasses.dataclass
class LFVTNode:
    tuples: list  # list[(set_id, size)] — size-descending within the node
    parent: Optional["LFVTNode"]
    children: list
    owners: list = dataclasses.field(default_factory=list)  # element ids with L(a) here
    # children keyed by their first 2-tuple (siblings never share one):
    # the insert's branch lookup, O(1) instead of a scan of ``children``
    by_head: dict = dataclasses.field(default_factory=dict, repr=False)

    def __hash__(self):
        return id(self)


class LFVT:
    """Linear FVT (paper §3.2): non-branching runs compressed into arrays.

    The element table maps ``a -> (|seq(a)|, node, offset)`` where
    ``(node, offset)`` addresses the last 2-tuple of ``seq(a)`` inside the
    compressed node — the paper's "L(a) points to a particular 2-tuple".
    """

    def __init__(self, S: SetCollection):
        self.root = LFVTNode([], None, [])
        self.element_table: dict[int, tuple[int, LFVTNode, int]] = {}
        self.n_nodes = 0
        self._build(S)

    # -------------------------------------------------------------- #
    def _build(self, S: SetCollection) -> None:
        for a, seq in build_seqs(S).items():
            self._insert(a, seq)

    def _set_entry(self, a: int, seq_len: int, node: LFVTNode, off: int) -> None:
        self.element_table[a] = (seq_len, node, off)
        node.owners.append(a)

    def _split(self, child: LFVTNode, k: int) -> None:
        """Split ``child`` at tuple offset ``k`` into head + tail nodes."""
        tail = LFVTNode(child.tuples[k:], child, child.children,
                        by_head=child.by_head)
        for c in tail.children:
            c.parent = tail
        child.tuples = child.tuples[:k]
        child.children = [tail]
        child.by_head = {tail.tuples[0]: tail}
        self.n_nodes += 1
        # repair element-table entries whose L(a) moved into the tail
        keep = []
        for a in child.owners:
            seq_len, _, off = self.element_table[a]
            if off >= k:
                self.element_table[a] = (seq_len, tail, off - k)
                tail.owners.append(a)
            else:
                keep.append(a)
        child.owners = keep

    def _insert(self, a: int, seq: list) -> None:
        node, i = self.root, 0  # i = matched length of seq
        while i < len(seq):
            child = node.by_head.get(seq[i])
            if child is None:
                # |pref| = 0 relative to this subtree: append a fresh node
                new = LFVTNode(list(seq[i:]), node, [])
                node.children.append(new)
                node.by_head[new.tuples[0]] = new
                self.n_nodes += 1
                self._set_entry(a, len(seq), new, len(new.tuples) - 1)
                return
            # match as far as possible inside `child`
            k = 0
            while k < len(child.tuples) and i + k < len(seq) and child.tuples[k] == seq[i + k]:
                k += 1
            i += k
            if k == len(child.tuples):
                node = child  # consumed the whole node, descend
                continue
            if i == len(seq):
                # |pref| >= |seq|: seq ends mid-node -> point L(a) at the
                # 2-tuple, no split (paper §3.2 first bullet)
                self._set_entry(a, len(seq), child, k - 1)
                return
            # partial match with branching: split child at offset k
            self._split(child, k)
            node = child
        # seq fully consumed at a node boundary: L(a) = last tuple of `node`
        self._set_entry(a, len(seq), node, len(node.tuples) - 1)

    # -------------------------------------------------------------- #
    def walk(self, a: int):
        """Yield (set_id, size) from L(a) to the root (exclusive)."""
        entry = self.element_table.get(a)
        if entry is None:
            return
        _, node, off = entry
        while node is not self.root:
            for k in range(off, -1, -1):
                yield node.tuples[k]
            node = node.parent
            off = len(node.tuples) - 1
