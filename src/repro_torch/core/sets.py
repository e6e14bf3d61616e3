"""Set-collection representations for the CF-RS-Join.

The paper operates on ragged collections of integer-element sets; the
device paths need dense, tile-friendly layouts. This module (a numpy copy
of the JAX package's ``core/sets.py``) owns every representation and the
host-side conversions between them:

  ragged   : list[np.ndarray]                     -- input format
  padded   : (n, max_len) int32, -1 padded        -- gather-friendly
  csr      : inverted index  element -> set ids   -- the "element table"
  flat     : ``FlatLFVT`` CSR arrays of the LFVT  -- the walk's input

``SetCollection`` also carries the descending-size sort that replaces the
FVT's "bigger sets closer to the root" invariant (DESIGN.md §2).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = ["SetCollection", "CollectionValidationError",
           "EmptyCollectionError", "length_filter_bounds", "jaccard",
           "similarity"]


class CollectionValidationError(ValueError):
    """A ``SetCollection`` violates its structural invariants (negative
    element ids, unsorted/duplicate elements, out-of-range universe, or
    mismatched id rows). Raised by constructors and ``validate()`` so
    bad inputs fail with a named error instead of an opaque downstream
    index fault."""


class EmptyCollectionError(ValueError):
    """An empty R or S collection reached a driver running with
    ``global_config.strict_validation`` on. By default empty inputs are
    legal (they produce empty joins); strict mode names them instead."""


def _write_protect(out) -> None:
    """Write-protect every ndarray leaf of a memoized representation.

    Derived reps are plain arrays, tuples of arrays, or dataclasses of
    arrays (``FlatLFVT``); all share one protection scheme so a cached
    rep can never be mutated behind the memo's back.
    """
    if isinstance(out, np.ndarray):
        out.setflags(write=False)
    elif isinstance(out, tuple):
        for a in out:
            _write_protect(a)
    elif dataclasses.is_dataclass(out):
        for f in dataclasses.fields(out):
            _write_protect(getattr(out, f.name))


def _as_ragged(sets: Sequence[np.ndarray]) -> list[np.ndarray]:
    out = []
    for s in sets:
        a = np.asarray(s, dtype=np.int32)
        if a.ndim != 1:
            raise ValueError(f"each set must be 1-D, got shape {a.shape}")
        out.append(np.unique(a))  # sets: dedupe + sort elements
    return out


@dataclasses.dataclass(eq=False)
class SetCollection:
    """A collection of sets over a dense integer universe ``[0, universe)``.

    Invariant: ``sets`` are element-sorted and deduplicated. When
    ``sorted_by_size`` is True, sets are ordered by (size desc, id asc) and
    ``ids[k]`` maps row ``k`` back to the original set id — the array
    analogue of the FVT size ordering.

    ``eq=False``: collections compare and hash by identity (the generated
    ``__eq__`` would be meaningless over ragged ndarray lists anyway),
    which lets device-resident representations be cached per collection in
    a ``WeakKeyDictionary`` (see ``tile_join``).

    Derived representations (``sizes``/``padded``/``csr``/``flat_lfvt``) are
    memoized on the instance — collections are immutable by convention, and
    the driver re-requests the same rep for the same collection many
    times. Cached arrays are returned write-protected.
    """

    sets: list[np.ndarray]
    universe: int
    ids: np.ndarray  # (n,) int32 original ids per row
    sorted_by_size: bool = False
    _reps: dict = dataclasses.field(default_factory=dict, repr=False)

    def _memo(self, key, build):
        out = self._reps.get(key)
        if out is None:
            out = build()
            _write_protect(out)
            self._reps[key] = out
        return out

    # ------------------------------------------------------------------ #
    # constructors
    # ------------------------------------------------------------------ #
    @classmethod
    def from_ragged(cls, sets: Sequence[np.ndarray], universe: int | None = None):
        ragged = _as_ragged(sets)
        if universe is None:
            universe = int(max((int(s[-1]) for s in ragged if len(s)), default=-1)) + 1
        for i, s in enumerate(ragged):
            if len(s) and s[0] < 0:
                raise CollectionValidationError(
                    f"set {i}: negative element id {int(s[0])}")
            if len(s) and s[-1] >= universe:
                raise CollectionValidationError(
                    f"set {i}: element id {int(s[-1])} outside universe "
                    f"[0, {universe})")
        return cls(ragged, universe, np.arange(len(ragged), dtype=np.int32))

    def sort_by_size(self) -> "SetCollection":
        """Order rows by (|S| desc, id asc) — the FVT root-ward invariant."""
        sizes = self.sizes()
        order = np.lexsort((self.ids, -sizes))
        return SetCollection(
            [self.sets[i] for i in order],
            self.universe,
            self.ids[order],
            sorted_by_size=True,
        )

    def validate(self) -> "SetCollection":
        """Check the structural invariants of a directly-constructed
        collection (``from_ragged`` enforces them on the way in, but
        drivers also accept hand-built / checkpoint-loaded instances).

        Raises :class:`CollectionValidationError` on the first violated
        invariant; returns ``self`` for chaining. Memoized — drivers
        call it per join, the scan runs once per collection.
        """
        def build():
            if len(self.ids) != len(self.sets):
                raise CollectionValidationError(
                    f"ids length {len(self.ids)} != set count "
                    f"{len(self.sets)}")
            for i, s in enumerate(self.sets):
                a = np.asarray(s)
                if a.ndim != 1:
                    raise CollectionValidationError(
                        f"set {i}: not 1-D (shape {a.shape})")
                if len(a) and int(a[0]) < 0:
                    raise CollectionValidationError(
                        f"set {i}: negative element id {int(a[0])}")
                if len(a) and int(a[-1]) >= self.universe:
                    raise CollectionValidationError(
                        f"set {i}: element id {int(a[-1])} outside "
                        f"universe [0, {self.universe})")
                d = np.diff(a)
                if len(d) and int(d.min()) <= 0:
                    k = int(np.argmax(d <= 0))
                    word = "duplicate" if int(d[k]) == 0 else "unsorted"
                    raise CollectionValidationError(
                        f"set {i}: {word} elements at position {k}")
            return np.bool_(True)

        self._memo("validated", build)
        return self

    # ------------------------------------------------------------------ #
    # views
    # ------------------------------------------------------------------ #
    def __len__(self) -> int:
        return len(self.sets)

    def sizes(self) -> np.ndarray:
        return self._memo(
            "sizes",
            lambda: np.asarray([len(s) for s in self.sets], dtype=np.int32))

    def padded(self, pad_to: int | None = None) -> tuple[np.ndarray, np.ndarray]:
        """(n, L) int32 with -1 padding, plus (n,) sizes. Memoized per L."""
        sizes = self.sizes()
        L = int(pad_to if pad_to is not None else max(int(sizes.max(initial=0)), 1))

        def build():
            out = np.full((len(self), L), -1, dtype=np.int32)
            for i, s in enumerate(self.sets):
                out[i, : len(s)] = s
            return out

        return self._memo(("padded", L), build), sizes

    def csr(self) -> tuple[np.ndarray, np.ndarray]:
        """Inverted index (element table): ``indptr`` (U+1,), ``setids``.

        ``setids[indptr[a]:indptr[a+1]]`` are the rows containing element
        ``a``. When the collection is size-sorted this is exactly the
        paper's ``seq(a)`` (size-descending), stored as one linear array —
        the LFVT layout.
        """
        def build():
            counts = np.zeros(self.universe + 1, dtype=np.int64)
            for s in self.sets:
                counts[s + 1] += 1
            indptr = np.cumsum(counts)
            setids = np.empty(int(indptr[-1]), dtype=np.int32)
            cursor = indptr[:-1].copy()
            for row, s in enumerate(self.sets):
                setids[cursor[s]] = row
                cursor[s] += 1
            return indptr.astype(np.int64), setids

        return self._memo("csr", build)

    def bitmaps(self, words: int | None = None) -> np.ndarray:
        """(n, W) uint32 membership bitmaps; bit ``a%32`` of word ``a//32``.

        Memoized per word width ``W``. The device paths upload the sheet
        as an int32 tensor with the same bits (``.view(np.int32)``): torch
        has almost no uint32 arithmetic, and the kernels read the words
        as ``uint32_t``.
        """
        W = words if words is not None else max((self.universe + 31) // 32, 1)

        def build():
            out = np.zeros((len(self), W), dtype=np.uint32)
            if not len(self):
                return out
            sizes = self.sizes().astype(np.int64)
            elems = (np.concatenate(self.sets).astype(np.int64)
                     if sizes.sum() else np.zeros(0, np.int64))
            rows = np.repeat(np.arange(len(self), dtype=np.int64), sizes)
            # elements are unique within a set, so OR-ing each bit once
            # is the whole sheet
            np.bitwise_or.at(out.reshape(-1), rows * W + elems // 32,
                             np.left_shift(np.uint32(1),
                                           (elems % 32).astype(np.uint32)))
            return out

        return self._memo(("bitmaps", W), build)

    def flat_lfvt(self):
        """Flat-array LFVT encoding of this collection (``FlatLFVT``).

        Memoized under one keyed slot like the padded/csr reps —
        the encoding is threshold- and measure-independent, so repeated
        joins at different ``t`` never rebuild the tree. The backing
        arrays come back write-protected like every other cached rep.
        """
        def build():
            from .lfvt_flat import encode  # deferred: sets is a leaf module
            return encode(self)

        return self._memo(("lfvt_flat",), build)

    def total_elements(self) -> int:
        return int(self.sizes().sum())


# ---------------------------------------------------------------------- #
# similarity + filter helpers (host reference semantics, float64)
# ---------------------------------------------------------------------- #
def jaccard(a: np.ndarray, b: np.ndarray) -> float:
    inter = len(np.intersect1d(a, b, assume_unique=True))
    union = len(a) + len(b) - inter
    return inter / union if union else 1.0


def similarity(a: np.ndarray, b: np.ndarray,
               measure: str = "jaccard") -> float:
    """Float64 reference similarity of two element-sorted sets."""
    from .measures import get_measure  # deferred: sets is a leaf module
    inter = len(np.intersect1d(a, b, assume_unique=True))
    return get_measure(measure).similarity(inter, len(a), len(b))


def length_filter_bounds(r_size: int | np.ndarray, t: float,
                         measure: str = "jaccard"):
    """Lemma 3.1 size window, generalized per measure (DESIGN.md §8).

    Jaccard: ceil(t|R|) <= |S| <= floor(|R|/t); see
    ``measures.Measure.size_window`` for the other three. Integer-exact
    (the threshold is resolved to a rational, no float ceil/floor).
    """
    from .measures import get_measure  # deferred: sets is a leaf module
    return get_measure(measure).size_window_arrays(
        np.asarray(r_size, dtype=np.int64), t)
