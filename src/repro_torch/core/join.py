"""Host reference CF-RS-Join algorithms (paper Algorithm 1) + brute force.

The port of the JAX package's ``core/join.py``, numpy only. These are the
exactness oracles: ``brute_force_join`` is the last rung of the
resilience ladders (``tile_join``, ``distributed``); ``cf_rs_join_fvt``
follows Algorithm 1 faithfully, including the ``support`` mechanism that
merges root-walks of multiple elements of the same ``R_i`` whose
``L(a)`` nodes lie on one root path; ``cf_rs_join_lfvt`` runs the same
traversal over the compressed tree (and carries ``fasttelp_sj`` in
``core/baselines.py``).

Pair semantics: ``(r, s)`` qualifies iff ``sim(f, |R|, |S|) >= t`` for the
chosen measure (Jaccard/Cosine/Dice/Overlap — DESIGN.md §8).
``brute_force_join`` evaluates the float64 similarity directly; the tree
traversals use the measure's integer-exact predicate and per-measure size
window.
"""
from __future__ import annotations

import math

import numpy as np

from .fvt import FVT, LFVT
from .measures import get_measure, numpy_qualify
from .sets import SetCollection, similarity

__all__ = [
    "brute_force_join",
    "cf_rs_join_fvt",
    "cf_rs_join_lfvt",
    "pairs_from_counts",
]


def pairs_from_counts(counts, r_ids, r_sizes, s_ids, s_sizes, t,
                      measure: str = "jaccard") -> set:
    """Threshold an (m, n) intersection-count matrix into a pair set."""
    mask = numpy_qualify(counts, r_sizes, s_sizes, t, measure)
    rr, ss = np.nonzero(mask)
    return {(int(r_ids[i]), int(s_ids[j])) for i, j in zip(rr, ss)}


def brute_force_join(R: SetCollection, S: SetCollection, t: float,
                     measure: str = "jaccard") -> set:
    """O(m*n) float64 oracle."""
    out = set()
    for i, Ri in enumerate(R.sets):
        for j, Sj in enumerate(S.sets):
            if len(Ri) and len(Sj) and similarity(Ri, Sj, measure) >= t:
                out.add((int(R.ids[i]), int(S.ids[j])))
    return out


# ---------------------------------------------------------------------- #
# Algorithm 1 — CF-RS-Join/FVT
# ---------------------------------------------------------------------- #
def cf_rs_join_fvt(R: SetCollection, S: SetCollection, t: float,
                   tree: FVT | None = None, stats: dict | None = None,
                   measure: str = "jaccard") -> set:
    tree = tree if tree is not None else FVT(S)
    m = get_measure(measure)
    pairs: set = set()
    visited = 0
    for i, Ri in enumerate(R.sets):
        if not len(Ri):
            continue
        r_size = len(Ri)
        r_min, r_max = m.size_window(r_size, t)
        r_max = math.inf if r_max is None else r_max
        # N: the L(a) start nodes, sorted by |seq(a)| ascending (Alg.1 l.8)
        starts = []
        for a in Ri:
            entry = tree.element_table.get(int(a))
            if entry is not None:
                starts.append(entry)
        starts.sort(key=lambda e: e[0])
        nodes = [e[1] for e in starts]
        f: dict[int, tuple[int, int]] = {}  # set_id -> (count, size)
        while nodes:
            node = nodes.pop()  # deepest remaining start (largest |seq|)
            support = 1
            while node is not tree.root and node.size <= r_max:
                visited += 1
                # merge walks that share this root path (Alg.1 l.14-16)
                for k in range(len(nodes) - 1, -1, -1):
                    if nodes[k] is node:
                        support += 1
                        del nodes[k]
                if node.size >= r_min:
                    c, sz = f.get(node.set_id, (0, node.size))
                    f[node.set_id] = (c + support, sz)
                node = node.parent
        for sid, (cnt, sz) in f.items():
            if m.qualifies(cnt, r_size, sz, t):
                pairs.add((int(R.ids[i]), sid))
    if stats is not None:
        stats["nodes_visited"] = visited
        stats["tree_nodes"] = tree.n_nodes
    return pairs


# ---------------------------------------------------------------------- #
# CF-RS-Join/LFVT — same traversal over the compressed tree
# ---------------------------------------------------------------------- #
def cf_rs_join_lfvt(R: SetCollection, S: SetCollection, t: float,
                    tree: LFVT | None = None, stats: dict | None = None,
                    measure: str = "jaccard") -> set:
    tree = tree if tree is not None else LFVT(S)
    m = get_measure(measure)
    pairs: set = set()
    visited = 0
    for i, Ri in enumerate(R.sets):
        if not len(Ri):
            continue
        r_size = len(Ri)
        r_min, r_max = m.size_window(r_size, t)
        r_max = math.inf if r_max is None else r_max
        # starts: (node, offset) positions, sorted by |seq(a)| ascending
        starts = []
        for a in Ri:
            entry = tree.element_table.get(int(a))
            if entry is not None:
                starts.append(entry)
        starts.sort(key=lambda e: e[0])
        positions = [(e[1], e[2]) for e in starts]
        f: dict[int, tuple[int, int]] = {}
        while positions:
            node, off = positions.pop()
            support = 1
            stop = False
            while node is not tree.root and not stop:
                for k in range(off, -1, -1):
                    sid, sz = node.tuples[k]
                    if sz > r_max:
                        stop = True
                        break
                    visited += 1
                    for q in range(len(positions) - 1, -1, -1):
                        if positions[q][0] is node and positions[q][1] == k:
                            support += 1
                            del positions[q]
                    if sz >= r_min:
                        c, _ = f.get(sid, (0, sz))
                        f[sid] = (c + support, sz)
                if not stop:
                    node = node.parent
                    off = len(node.tuples) - 1
        for sid, (cnt, sz) in f.items():
            if m.qualifies(cnt, r_size, sz, t):
                pairs.add((int(R.ids[i]), sid))
    if stats is not None:
        stats["nodes_visited"] = visited
        stats["tree_nodes"] = tree.n_nodes
    return pairs
