"""Pluggable set-similarity measures (DESIGN.md §8).

The paper's FVT/LFVT machinery (§3) is measure-agnostic: any similarity
that reduces to (a) an overlap threshold ``f >= minoverlap(|R|, |S|)`` and
(b) a size window ``|S| in [lo(|R|), hi(|R|)]`` (Lemma 3.1 generalized)
drops into the same candidate-free traversal, tile schedule and MR
routing. This module owns those reductions for Jaccard, Cosine, Dice and
Overlap — the standard generalization in the set-join literature (e.g. the
Bitmap Filter paper, arXiv:1711.07295, derives its bitwise filters for the
same four).

Exactness contract
------------------
Float thresholds are resolved once to an exact small rational
``t = P/Q`` (``threshold_fraction``); every predicate is then evaluated as
a cross-multiplied *integer* comparison — no float division, no float32
rounding at the qualify boundary (the bug this layer replaces: see
``tests/test_measures.py::test_float32_boundary_regression``):

  measure    similarity            integer predicate (f > 0 required)
  ---------  --------------------  ----------------------------------
  jaccard    f / (r + s - f)       f·(P+Q)   >= P·(r+s)
  cosine     f / sqrt(r·s)         f²·Q²     >= P²·r·s
  dice       2f / (r + s)          f·2Q      >= P·(r+s)
  overlap    f / min(r, s)         f·Q       >= P·min(r,s)

and the per-measure inclusive size windows (``size_window``):

  jaccard    [ceil(t·r),          floor(r/t)]
  cosine     [ceil(t²·r),         floor(r/t²)]
  dice       [ceil(t·r/(2-t)),    floor((2-t)·r/t)]
  overlap    [1,                  ∞)

Host-side predicates run in arbitrary-precision Python ints (always
exact). Device-side (``device_qualify``, the plain PyTorch form of the
predicate the CUDA walk kernel evaluates) runs in int32;
``Measure.validate`` checks the
worst-case product magnitudes against 2**31 for the caller's maximum set
size, so the comparison is provably exact whenever a driver accepts the
inputs.
"""
from __future__ import annotations

import functools
import math
from fractions import Fraction

import numpy as np
import torch

__all__ = [
    "Measure",
    "MEASURES",
    "get_measure",
    "measure_names",
    "threshold_fraction",
    "device_qualify",
    "numpy_qualify",
    "MEASURE_CODES",
]

# Resolves any threshold written with <= 6 decimal digits (0.7, 0.875, ...)
# and any simple fraction (2/3, 1/7, ...) to its exact intended rational;
# for other floats it is the best rational approximation with denominator
# below this bound (within 1/(Q * 10^6) of the float).
MAX_DENOMINATOR = 10**6

# "no upper size bound" sentinel (overlap): larger than any set size while
# leaving int64 headroom for searchsorted / arithmetic on the arrays.
SIZE_INF = np.int64(2**62)


@functools.lru_cache(maxsize=256)
def threshold_fraction(t: float) -> tuple[int, int]:
    """Exact rational reading ``(P, Q)`` of a float threshold, lowest terms."""
    t = float(t)
    if not (0.0 < t <= 1.0):
        raise ValueError(f"threshold must be in (0, 1], got {t}")
    fr = Fraction(t).limit_denominator(MAX_DENOMINATOR)
    return fr.numerator, fr.denominator


def _cdiv(a, b):
    """Exact ceil(a / b) for non-negative ints (works on np int64 arrays)."""
    return (a + b - 1) // b


def _ceil_sqrt(x: int) -> int:
    """Exact ceil(sqrt(x)) for a non-negative Python int."""
    if x <= 0:
        return 0
    r = math.isqrt(x - 1)
    return r + 1


class Measure:
    """One similarity measure: predicate algebra + size window + reference.

    Subclasses supply the three integer reductions; instances are stateless
    singletons (thresholds are per-call, so one instance serves every
    ``t``). ``name`` is what the device paths take.
    """

    name: str = "?"

    # ------------------------------------------------------------------ #
    # (c) float64 host reference
    # ------------------------------------------------------------------ #
    def similarity(self, f: int, r_size: int, s_size: int) -> float:
        raise NotImplementedError

    # ------------------------------------------------------------------ #
    # (a) exact overlap-threshold predicate
    # ------------------------------------------------------------------ #
    def _cross(self, f, r, s, p: int, q: int):
        """-> (lhs, rhs) of the cross-multiplied comparison lhs >= rhs.

        Must be algebra shared by every numeric backend: Python ints
        (exact host predicate), np.int64 (vectorized host masks) and
        torch.int32 (device tensors) all evaluate the same expression.
        """
        raise NotImplementedError

    def qualifies(self, f: int, r_size: int, s_size: int, t: float) -> bool:
        """Exact predicate ``sim(f, r, s) >= t`` in Python ints."""
        if f <= 0:
            return False
        p, q = threshold_fraction(t)
        lhs, rhs = self._cross(int(f), int(r_size), int(s_size), p, q)
        return lhs >= rhs

    def min_overlap(self, r_size: int, s_size: int, t: float) -> int:
        """Smallest integer f with ``qualifies(f, r_size, s_size, t)``."""
        raise NotImplementedError

    # ------------------------------------------------------------------ #
    # (b) per-measure size window (Lemma 3.1 generalized)
    # ------------------------------------------------------------------ #
    def size_window(self, r_size: int, t: float) -> tuple[int, int | None]:
        """Inclusive |S| bounds for a qualifying partner; hi=None means ∞."""
        raise NotImplementedError

    def size_window_arrays(self, r_sizes: np.ndarray, t: float):
        """Vectorized ``size_window`` -> (lo, hi) int64 arrays (hi capped
        at ``SIZE_INF`` for unbounded measures)."""
        raise NotImplementedError

    # ------------------------------------------------------------------ #
    # derived filters
    # ------------------------------------------------------------------ #
    def prefix_min_overlap(self, size: int, t: float) -> int:
        """Lower bound on |x ∩ y| over all partners y in the size window —
        the prefix-filter bound of the baselines (prefix length = size -
        this + 1). Equals the window's lower size bound for all four
        measures."""
        lo, _ = self.size_window(size, t)
        return max(1, lo)

    def window_fraction(self, r_sizes: np.ndarray, s_sizes: np.ndarray,
                        t: float) -> float:
        """Mean Lemma-3.1 window width over R as a fraction of |S|.

        The planner's probe feature: how much of the comparison sheet the
        size filter leaves alive for this (measure, t, size profile).
        O(m log n + n log n) on the host; 0.0 for empty inputs.
        """
        r_sizes = np.asarray(r_sizes, dtype=np.int64)
        s_asc = np.sort(np.asarray(s_sizes, dtype=np.int64))
        n = len(s_asc)
        if n == 0 or len(r_sizes) == 0:
            return 0.0
        lo, hi = self.size_window_arrays(r_sizes, t)
        width = (np.searchsorted(s_asc, np.minimum(hi, SIZE_INF), "right")
                 - np.searchsorted(s_asc, lo, "left"))
        return float(np.maximum(width, 0).mean() / n)

    # ------------------------------------------------------------------ #
    # int32 exactness guard for the device paths
    # ------------------------------------------------------------------ #
    def _device_worst(self, n: int, p: int, q: int) -> int:
        """Largest intermediate the device comparison can produce for set
        sizes up to ``n`` (f = r = s = n is the worst case)."""
        lhs, rhs = self._cross(n, n, n, p, q)
        return max(abs(int(lhs)), abs(int(rhs)))

    def validate(self, t: float, max_size: int) -> None:
        """Raise if the int32 device comparison could overflow.

        Host drivers call this before launching kernels; a rejected
        (measure, t, max_size) combination must use a threshold with a
        smaller denominator or smaller sets.
        """
        p, q = threshold_fraction(t)
        n = int(max_size)
        if self._device_worst(n, p, q) >= 2**31:
            raise ValueError(
                f"measure {self.name!r} with t={t} (= {p}/{q}) overflows "
                f"int32 for set sizes up to {n}; use a threshold with a "
                f"smaller denominator or smaller sets")


class Jaccard(Measure):
    name = "jaccard"

    def similarity(self, f, r_size, s_size):
        union = r_size + s_size - f
        return f / union if union else 1.0

    def _cross(self, f, r, s, p, q):
        return f * (p + q), p * (r + s)

    def min_overlap(self, r_size, s_size, t):
        p, q = threshold_fraction(t)
        return max(1, _cdiv(p * (r_size + s_size), p + q))

    def size_window(self, r_size, t):
        p, q = threshold_fraction(t)
        return _cdiv(p * r_size, q), (q * r_size) // p

    def size_window_arrays(self, r_sizes, t):
        p, q = threshold_fraction(t)
        r = np.asarray(r_sizes, dtype=np.int64)
        return _cdiv(p * r, q), (q * r) // p


class Cosine(Measure):
    name = "cosine"

    def similarity(self, f, r_size, s_size):
        denom = math.sqrt(r_size * s_size)
        return f / denom if denom else 1.0

    def _cross(self, f, r, s, p, q):
        return (f * f) * (q * q), (p * p) * (r * s)

    def min_overlap(self, r_size, s_size, t):
        p, q = threshold_fraction(t)
        # smallest f with (f·q)² >= p²·r·s
        return max(1, _cdiv(_ceil_sqrt(p * p * r_size * s_size), q))

    def size_window(self, r_size, t):
        p, q = threshold_fraction(t)
        return _cdiv(p * p * r_size, q * q), (q * q * r_size) // (p * p)

    def size_window_arrays(self, r_sizes, t):
        p, q = threshold_fraction(t)
        r = np.asarray(r_sizes, dtype=np.int64)
        return _cdiv(p * p * r, q * q), (q * q * r) // (p * p)

    def _device_worst(self, n, p, q):
        # the device path uses the division form (see device_qualify):
        # f² >= ceil(p²·r·s / q²) — intermediates f² and p²rs + q² - 1
        return max(n * n, p * p * n * n + q * q - 1)


class Dice(Measure):
    name = "dice"

    def similarity(self, f, r_size, s_size):
        total = r_size + s_size
        return 2 * f / total if total else 1.0

    def _cross(self, f, r, s, p, q):
        return f * (2 * q), p * (r + s)

    def min_overlap(self, r_size, s_size, t):
        p, q = threshold_fraction(t)
        return max(1, _cdiv(p * (r_size + s_size), 2 * q))

    def size_window(self, r_size, t):
        p, q = threshold_fraction(t)
        return _cdiv(p * r_size, 2 * q - p), ((2 * q - p) * r_size) // p

    def size_window_arrays(self, r_sizes, t):
        p, q = threshold_fraction(t)
        r = np.asarray(r_sizes, dtype=np.int64)
        return _cdiv(p * r, 2 * q - p), ((2 * q - p) * r) // p


class Overlap(Measure):
    name = "overlap"

    def similarity(self, f, r_size, s_size):
        m = min(r_size, s_size)
        return f / m if m else 1.0

    def _cross(self, f, r, s, p, q):
        # plain ints keep arbitrary precision; arrays broadcast elementwise
        mins = min(r, s) if isinstance(r, int) and isinstance(s, int) else (
            np.minimum(r, s))
        return f * q, p * mins

    def min_overlap(self, r_size, s_size, t):
        p, q = threshold_fraction(t)
        return max(1, _cdiv(p * min(r_size, s_size), q))

    def size_window(self, r_size, t):
        return 1, None

    def size_window_arrays(self, r_sizes, t):
        r = np.asarray(r_sizes, dtype=np.int64)
        # empty R sets can never pair: give them an empty window
        return np.ones_like(r), np.where(r > 0, SIZE_INF, np.int64(0))


MEASURES: dict[str, Measure] = {
    m.name: m for m in (Jaccard(), Cosine(), Dice(), Overlap())
}


def measure_names() -> tuple[str, ...]:
    return tuple(MEASURES)


def get_measure(measure: str | Measure) -> Measure:
    if isinstance(measure, Measure):
        return measure
    m = MEASURES.get(measure)
    if m is None:
        raise ValueError(
            f"unknown measure {measure!r}; known: {sorted(MEASURES)}")
    return m


def _measure_name(measure: str | Measure) -> str:
    return measure.name if isinstance(measure, Measure) else measure


# ---------------------------------------------------------------------- #
# device-side predicate — the plain PyTorch form of the int32 algebra the
# CUDA walk kernel (kernels/csrc/lfvt_walk.cu) evaluates
# ---------------------------------------------------------------------- #
#: measure name -> the integer code the CUDA kernels take
MEASURE_CODES = {"jaccard": 0, "cosine": 1, "dice": 2, "overlap": 3}


def device_qualify(counts, r_sizes, s_sizes, t: float,
                   measure: str | Measure = "jaccard"):
    """Integer-exact ``sim >= t`` as a boolean tensor (torch, int32 math).

    ``counts`` may be any numeric dtype holding exact integers;
    ``r_sizes``/``s_sizes`` must broadcast against it (e.g. (m, 1) and
    (1, n) against an (m, n) tile). The rational ``p/q`` of ``t`` enters
    as Python ints, which torch keeps at the tensors' int32 width.
    ``Measure.validate`` bounds every intermediate below 2**31.
    """
    name = _measure_name(measure)
    if name not in MEASURES:
        raise ValueError(
            f"unknown measure {name!r}; known: {sorted(MEASURES)}")
    p, q = threshold_fraction(t)
    f = counts.to(torch.int32)
    r = r_sizes.to(torch.int32)
    s = s_sizes.to(torch.int32)
    if name == "jaccard":
        ok = f * (p + q) >= p * (r + s)
    elif name == "cosine":
        # division form of f²q² >= p²rs: f² >= ceil(p²·r·s / q²). Exact
        # (both sides integers, operands non-negative) and the largest
        # intermediate is p²·rs + q² instead of f²·q²
        ok = f * f >= torch.div(p * p * (r * s) + (q * q - 1), q * q,
                                rounding_mode="floor")
    elif name == "dice":
        ok = f * (2 * q) >= p * (r + s)
    else:  # overlap
        ok = f * q >= p * torch.minimum(r, s)
    return ok & (f > 0)


def numpy_qualify(counts, r_sizes, s_sizes, t: float,
                  measure: str | Measure = "jaccard"):
    """Host twin of ``device_qualify``: exact numpy mask (m, n).

    int64 fast path; if the worst-case cross products could wrap (big
    threshold denominators x big sizes, e.g. cosine squaring both), the
    arrays are promoted to object dtype — arbitrary-precision Python
    ints — so the host predicate is exact for every input.
    """
    m = get_measure(measure)
    p, q = threshold_fraction(t)
    f = np.asarray(counts).astype(np.int64)
    r = np.asarray(r_sizes, dtype=np.int64).reshape(-1, 1)
    s = np.asarray(s_sizes, dtype=np.int64).reshape(1, -1)
    nmax = int(max(f.max(initial=0), r.max(initial=0), s.max(initial=0), 1))
    lhs_w, rhs_w = m._cross(nmax, nmax, nmax, p, q)
    if max(int(lhs_w), int(rhs_w)) >= 2**63:
        f, r, s = f.astype(object), r.astype(object), s.astype(object)
    lhs, rhs = m._cross(f, r, s, p, q)
    return np.asarray((lhs >= rhs) & (f > 0), dtype=bool)
