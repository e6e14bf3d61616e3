"""Host oracle of the join: ``brute_force_join``.

The port of the JAX package's ``core/join.py::brute_force_join``: the
last rung of the resilience ladders (``tile_join``, ``distributed``).
``(r, s)`` qualifies iff ``sim(f, |R|, |S|) >= t`` for the chosen measure
(Jaccard/Cosine/Dice/Overlap — DESIGN.md §8), evaluated in float64.
"""
from __future__ import annotations

from .sets import SetCollection, similarity

__all__ = ["brute_force_join"]


def brute_force_join(R: SetCollection, S: SetCollection, t: float,
                     measure: str = "jaccard") -> set:
    """O(m*n) float64 oracle."""
    out = set()
    for i, Ri in enumerate(R.sets):
        for j, Sj in enumerate(S.sets):
            if len(Ri) and len(Sj) and similarity(Ri, Sj, measure) >= t:
                out.add((int(R.ids[i]), int(S.ids[j])))
    return out
