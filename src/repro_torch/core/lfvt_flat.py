"""Flat-array Linear FVT: the LFVT encoding as linear int32 arrays plus
the whole-block array walk, in PyTorch.

The port of the JAX package's ``core/lfvt_flat.py``. ``encode`` (numpy,
byte-for-byte the reference's encoder) compiles the pointer-based
``LFVT`` (core/fvt.py) into CSR-style int32 arrays; ``to_device``
uploads the arrays the walk reads as torch tensors, once per device;
``from_arrays`` rebuilds a table from the reference's ``arrays()`` so a
table encoded by either package can feed the other's walk.
``pad_flat_tables`` sentinel-pads a table to given capacities and
``entry_positions`` resolves its entries to walk positions (the mesh
path's shard tables, ``core/distributed.py``); ``IncrementalLFVT``
grows a padded table in place as sets are admitted (the dedup service's
corpus, ``serve/dedup.py``).

Array schema (node 0 is the root: empty sequence, parent -1):

  node table   node_seq_off/len (N,)   slice of the node's tuples in the
                                       concatenated sequence arrays
               node_parent      (N,)   parent node id (-1 for the root)
               child_indptr/ids        child CSR (structure/decode only;
                                       the rootward walk never reads it)
               owner_indptr/elems      owner CSR: element ids with L(a)
                                       in this node, sorted, dup-free
  sequences    seq_row          (T,)   T = Σ|tuples| = FVT node count;
                                       rows into the size-sorted S
               seq_next         (T,)   the position the rootward walk
                                       visits after p (-1 past the
                                       root): one gather per step
  entry table  entry_elem       (E,)   sorted distinct element ids with
                                       a non-empty seq; lookup is a
                                       binary search
               entry_node/off   (E,)   L(a) address: node id + offset of
                                       the 2-tuple inside the node
               entry_len        (E,)   |seq(a)|
  collection   s_ids, s_sizes   (n,)   size-sorted row -> external id/size

Traversal (per R element, every lane in lockstep):

  node, off, rem <- entry row (searchsorted)  # rem = |seq(a)| steps
  repeat max(|seq|) times:
    row <- seq_row[node_seq_off[node] + off]   # emit: f[row] += 1
    stop the lane once row < lo (window early stop, Theorem 3.3 —
      walk rows are strictly decreasing)
    off -= 1; if off < 0: node <- parent, off <- node_seq_len-1

then qualify ``f`` with ``measures.device_qualify`` and the per-row
column window. ``_walk_counts`` is the reference's ``lfvt_ref`` walk;
the tiled CUDA kernel of ``kernels/lfvt_walk.py`` is the fast path.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from . import measures
from .fvt import FVT, LFVT
from .sets import SetCollection

__all__ = ["FlatLFVT", "FlatLFVTDevice", "FlatLFVTError", "IncrementalLFVT",
           "encode", "entry_positions", "flat_join_mask", "flat_walk_caps",
           "pad_flat_tables"]


class FlatLFVTError(ValueError):
    """A ``FlatLFVT`` violates its structural invariants — corrupted or
    untrusted arrays caught by :meth:`FlatLFVT.validate` before a walk
    can chase bad indices."""


class FlatLFVTDevice(NamedTuple):
    """Device-resident (torch int32) subset of the arrays the walk reads."""

    entry_elem: torch.Tensor
    entry_node: torch.Tensor
    entry_off: torch.Tensor
    entry_len: torch.Tensor
    node_seq_off: torch.Tensor
    node_seq_len: torch.Tensor
    node_parent: torch.Tensor
    seq_row: torch.Tensor
    seq_next: torch.Tensor
    s_sizes: torch.Tensor


@dataclasses.dataclass(eq=False)
class FlatLFVT:
    """An LFVT compiled into linear int32 arrays (schema in module doc)."""

    node_seq_off: np.ndarray   # (N,)
    node_seq_len: np.ndarray   # (N,)
    node_parent: np.ndarray    # (N,) -1 for the root
    child_indptr: np.ndarray   # (N+1,)
    child_ids: np.ndarray      # (N-1,) every non-root node is one child
    owner_indptr: np.ndarray   # (N+1,)
    owner_elems: np.ndarray    # (#distinct elements,)
    seq_row: np.ndarray        # (T,) rows into the size-sorted S
    seq_next: np.ndarray       # (T,) fused rootward hop (-1 past root)
    entry_elem: np.ndarray     # (E,) sorted present element ids
    entry_node: np.ndarray     # (E,)
    entry_off: np.ndarray      # (E,)
    entry_len: np.ndarray      # (E,)
    s_ids: np.ndarray          # (n,)
    s_sizes: np.ndarray        # (n,)
    universe: int
    max_seq_len: int           # static bound on walk length
    # per-device uploads, keyed by str(torch.device)
    _device: dict = dataclasses.field(default_factory=dict, repr=False)

    @classmethod
    def from_arrays(cls, arrays, universe: int,
                    max_seq_len: int) -> "FlatLFVT":
        """Rebuild a table from the backing arrays in field order — the
        form ``arrays()`` returns here and in the JAX package — then
        ``validate()`` it (the arrays come from outside this process)."""
        names = [f.name for f in dataclasses.fields(cls)
                 if f.type == "np.ndarray"]
        arrays = list(arrays)
        if len(arrays) != len(names):
            raise FlatLFVTError(
                f"from_arrays: expected {len(names)} arrays ({names}), "
                f"got {len(arrays)}")
        kw = {name: np.array(a, dtype=np.int32, copy=True)
              for name, a in zip(names, arrays)}
        return cls(**kw, universe=int(universe),
                   max_seq_len=int(max_seq_len)).validate()

    # -------------------------------------------------------------- #
    @property
    def n_nodes(self) -> int:
        """Node count including the root (pointer LFVT's n_nodes + 1)."""
        return len(self.node_seq_off)

    @property
    def n_sets(self) -> int:
        return len(self.s_ids)

    def arrays(self) -> tuple[np.ndarray, ...]:
        """Every backing array, in field order — the serialized form."""
        return tuple(
            a for f in dataclasses.fields(self)
            if isinstance(a := getattr(self, f.name), np.ndarray))

    def nbytes(self) -> int:
        """Total encoded bytes (what a shard ships / the device holds)."""
        return int(sum(a.nbytes for a in self.arrays()))

    # -------------------------------------------------------------- #
    def entry_of(self, a: int):
        """L(a) address ``(node id, offset, |seq(a)|)`` or None if the
        element occurs in no set (binary search over ``entry_elem``)."""
        i = int(np.searchsorted(self.entry_elem, a))
        if i >= len(self.entry_elem) or int(self.entry_elem[i]) != a:
            return None
        return (int(self.entry_node[i]), int(self.entry_off[i]),
                int(self.entry_len[i]))

    def walk(self, a: int):
        """Yield (set_id, size) from L(a) to the root — ``LFVT.walk``."""
        entry = self.entry_of(a) if 0 <= a < self.universe else None
        if entry is None:
            return
        node, off, _ = entry
        while node > 0:
            base = int(self.node_seq_off[node])
            for k in range(off, -1, -1):
                row = int(self.seq_row[base + k])
                yield int(self.s_ids[row]), int(self.s_sizes[row])
            node = int(self.node_parent[node])
            off = int(self.node_seq_len[node]) - 1

    def owners(self, nid: int) -> np.ndarray:
        """Element ids whose L(a) lies in node ``nid`` (sorted)."""
        return self.owner_elems[
            int(self.owner_indptr[nid]): int(self.owner_indptr[nid + 1])]

    def children(self, nid: int) -> np.ndarray:
        return self.child_ids[
            int(self.child_indptr[nid]): int(self.child_indptr[nid + 1])]

    # -------------------------------------------------------------- #
    def validate(self) -> "FlatLFVT":
        """Cheap structural check of the linear arrays (all vectorized,
        O(N + T + E + n)); raises :class:`FlatLFVTError` on the first
        violated invariant, returns ``self`` for chaining.

        Meant for untrusted tables — state carried across from another
        process (``from_arrays``), checkpoint loads — where a bad index
        would otherwise surface as an out-of-bounds gather on the device
        or a host IndexError deep in a walk.
        """
        def fail(msg: str):
            raise FlatLFVTError(f"FlatLFVT invariant violated: {msg}")

        N, T = self.n_nodes, len(self.seq_row)
        E, n = len(self.entry_elem), self.n_sets
        if (len(self.node_seq_len) != N or len(self.node_parent) != N
                or len(self.child_indptr) != N + 1
                or len(self.owner_indptr) != N + 1):
            fail("node-table column lengths disagree")
        if len(self.seq_next) != T:
            fail("seq_row/seq_next lengths disagree")
        if any(len(a) != E for a in
               (self.entry_node, self.entry_off, self.entry_len)):
            fail("entry-table column lengths disagree")
        if len(self.s_sizes) != n:
            fail("s_ids/s_sizes lengths disagree")
        if N == 0:
            fail("empty node table (the root node is mandatory)")
        # node table: sequence slices inside [0, T), parents in [-1, N)
        off, ln = self.node_seq_off, self.node_seq_len
        if ((ln < 0).any() or (off < 0).any()
                or (off.astype(np.int64) + ln > T).any()):
            fail("node sequence slice outside [0, T)")
        if (self.node_parent < -1).any() or (self.node_parent >= N).any():
            fail("node_parent outside [-1, N)")
        if int(self.node_parent[0]) != -1 or int(ln[0]) != 0:
            fail("node 0 is not an empty-sequence root")
        # sequence arrays: rows address S, hops stay inside the table
        if T and ((self.seq_row < 0).any() or (self.seq_row >= n).any()):
            fail("seq_row outside [0, n_sets)")
        if T and ((self.seq_next < -1).any() or (self.seq_next >= T).any()):
            fail("seq_next outside [-1, T)")
        # entry table: sorted, sentinels a suffix, addresses in range
        real = self.entry_elem < np.int64(self.universe)
        n_real = int(real.sum())
        if not real[:n_real].all():
            fail("sentinel entry rows are not a contiguous suffix")
        if n_real and (np.diff(self.entry_elem[:n_real]) <= 0).any():
            fail("entry_elem not strictly increasing")
        if E and (np.diff(self.entry_elem.astype(np.int64)) < 0).any():
            fail("entry_elem not sorted")
        if n_real and int(self.entry_elem[0]) < 0:
            fail("negative entry element id")
        if E and ((self.entry_node < 0).any()
                  or (self.entry_node >= N).any()):
            fail("entry_node outside [0, N)")
        if (self.entry_len < 0).any() or (self.entry_len > T).any():
            fail("entry_len outside [0, T]")
        live = self.entry_len > 0
        if live.any():
            en, eo = self.entry_node[live], self.entry_off[live]
            if (eo < 0).any() or (eo >= ln[en]).any():
                fail("entry_off outside its node's sequence slice")
        if (~real & live).any():
            fail("sentinel entry row with a non-empty sequence")
        # collection rows: padded (-1 id) rows a zero-size suffix
        if (self.s_sizes < 0).any():
            fail("negative s_sizes")
        pad_rows = self.s_ids < 0
        n_live = n - int(pad_rows.sum())
        if pad_rows[:n_live].any():
            fail("padded (-1) s_ids rows are not a contiguous suffix")
        if pad_rows.any() and self.s_sizes[pad_rows].any():
            fail("padded s_ids row with non-zero s_sizes")
        return self

    # -------------------------------------------------------------- #
    def to_device(self, device) -> FlatLFVTDevice:
        """Upload the walk arrays to ``device`` once; cached on the
        instance per device (the S-rep cache in ``tile_join`` keeps the
        FlatLFVT itself alive). ``"cuda"`` and the current card's
        ``"cuda:N"`` share one upload."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        key = str(device)
        dev = self._device.get(key)
        if dev is None:
            dev = FlatLFVTDevice(*(
                torch.as_tensor(np.ascontiguousarray(a, np.int32).copy(),
                                device=device)
                for a in (self.entry_elem, self.entry_node, self.entry_off,
                          self.entry_len, self.node_seq_off,
                          self.node_seq_len, self.node_parent, self.seq_row,
                          self.seq_next, self.s_sizes)))
            self._device[key] = dev
        return dev

    def drop_uploads(self) -> None:
        """Forget every device's upload; the next ``to_device`` copies
        the arrays again."""
        self._device.clear()


# ---------------------------------------------------------------------- #
# encoder
# ---------------------------------------------------------------------- #
def _tree_adapters(tree):
    """(tuples_of, children_of) unifying FVT and LFVT node shapes."""
    if isinstance(tree, FVT):
        return (lambda nd: [] if nd is tree.root else [(nd.set_id, nd.size)],
                lambda nd: list(nd.children.values()))
    return (lambda nd: nd.tuples, lambda nd: nd.children)


def _tree_entries(tree):
    """element id -> (node, offset-in-node, |seq(a)|), FVT or LFVT."""
    out = {}
    for a, e in tree.element_table.items():
        if isinstance(tree, FVT):
            seq_len, node = e
            off = 0  # FVT nodes hold exactly one 2-tuple
        else:
            seq_len, node, off = e
        out[a] = (node, off, seq_len)
    return out


def encode(S: SetCollection, tree: FVT | LFVT | None = None) -> FlatLFVT:
    """Compile the LFVT of ``S`` into a :class:`FlatLFVT`.

    ``tree`` defaults to ``LFVT(S)``; passing an ``FVT`` yields the
    uncompressed flat encoding (one tuple per node) — walks are
    identical either way, which the structural test suite pins down.
    The encoding is threshold-independent: one FlatLFVT serves every
    ``t`` and every measure.
    """
    Ss = S if S.sorted_by_size else S.sort_by_size()
    tree = LFVT(S) if tree is None else tree
    tuples_of, children_of = _tree_adapters(tree)
    row_of = {int(sid): r for r, sid in enumerate(Ss.ids)}

    # pre-order DFS: root gets id 0, children in insertion order
    order = [tree.root]
    stack = list(reversed(children_of(tree.root)))
    while stack:
        nd = stack.pop()
        order.append(nd)
        stack.extend(reversed(children_of(nd)))
    ids = {id(nd): nid for nid, nd in enumerate(order)}
    N = len(order)

    seq_off = np.zeros(N, np.int32)
    seq_len = np.zeros(N, np.int32)
    parent = np.full(N, -1, np.int32)
    child_lists: list[list[int]] = [[] for _ in range(N)]
    rows: list[int] = []
    for nid, nd in enumerate(order):
        tups = tuples_of(nd)
        seq_off[nid] = len(rows)
        seq_len[nid] = len(tups)
        rows.extend(row_of[int(sid)] for sid, _ in tups)
        for c in children_of(nd):
            cid = ids[id(c)]
            parent[cid] = nid
            child_lists[nid].append(cid)

    child_counts = np.asarray([len(c) for c in child_lists], np.int64)
    child_indptr = np.concatenate([[0], np.cumsum(child_counts)]).astype(
        np.int32)
    child_ids = (np.concatenate([np.asarray(c, np.int32)
                                 for c in child_lists if c])
                 if child_counts.sum() else np.zeros(0, np.int32))

    entries = _tree_entries(tree)
    entry_elem = np.sort(np.fromiter(entries, np.int32, len(entries)))
    entry_node = np.zeros(len(entries), np.int32)
    entry_off = np.zeros(len(entries), np.int32)
    entry_len = np.zeros(len(entries), np.int32)
    owner_lists: list[list[int]] = [[] for _ in range(N)]
    for i, a in enumerate(map(int, entry_elem)):
        nd, off, sl = entries[a]
        nid = ids[id(nd)]
        entry_node[i] = nid
        entry_off[i] = off
        entry_len[i] = sl
        owner_lists[nid].append(a)
    owner_counts = np.asarray([len(o) for o in owner_lists], np.int64)
    owner_indptr = np.concatenate([[0], np.cumsum(owner_counts)]).astype(
        np.int32)
    owner_elems = (np.concatenate([np.sort(np.asarray(o, np.int32))
                                   for o in owner_lists if o])
                   if owner_counts.sum() else np.zeros(0, np.int32))

    # fused rootward hop: within a node the walk moves to the previous
    # position; at a node's first position it jumps to the parent's last
    # (-1 once the parent is the empty-sequence root)
    T = len(rows)
    seq_next = np.arange(-1, T - 1, dtype=np.int32)
    nonroot = np.nonzero(seq_len > 0)[0]
    par = parent[nonroot]
    par_end = np.where(seq_len[par] > 0,
                       seq_off[par] + seq_len[par] - 1, -1).astype(np.int32)
    seq_next[seq_off[nonroot]] = par_end

    return FlatLFVT(
        node_seq_off=seq_off, node_seq_len=seq_len, node_parent=parent,
        child_indptr=child_indptr, child_ids=child_ids,
        owner_indptr=owner_indptr, owner_elems=owner_elems,
        seq_row=np.asarray(rows, np.int32), seq_next=seq_next,
        entry_elem=entry_elem, entry_node=entry_node, entry_off=entry_off,
        entry_len=entry_len,
        s_ids=Ss.ids.astype(np.int32), s_sizes=Ss.sizes().astype(np.int32),
        universe=int(S.universe), max_seq_len=int(entry_len.max(initial=0)))


# ---------------------------------------------------------------------- #
# sentinel padding: rectangular flat tables
# ---------------------------------------------------------------------- #
#: element id of padded entry rows: int32 max keeps the entry table
#: sorted and never equals a real element (ids are < universe <= 2^31-1)
PAD_SENTINEL = 2 ** 31 - 1


def entry_positions(flat: FlatLFVT) -> np.ndarray:
    """(E,) absolute walk start per entry: ``node_seq_off[entry_node] +
    entry_off``. Precomputed on the host so mesh shards ship only the
    entry/seq tables — the walk never needs the node table once entries
    are resolved to positions (the fused ``seq_next`` hop already
    encodes the parent chain)."""
    if not len(flat.entry_elem):
        return np.zeros(0, np.int32)
    return (flat.node_seq_off[flat.entry_node]
            + flat.entry_off).astype(np.int32)


def flat_walk_caps(flat: FlatLFVT) -> dict:
    """The table sizes that make flat arrays ragged: node/seq/entry/set
    counts plus the static walk bound."""
    return {"n_nodes": flat.n_nodes, "n_seq": len(flat.seq_row),
            "n_entries": len(flat.entry_elem), "n_sets": flat.n_sets,
            "max_seq_len": flat.max_seq_len}


def _pad1(a: np.ndarray, size: int, fill, name: str = "array") -> np.ndarray:
    # a shrinking cap would silently truncate the table: raise the named
    # error (the field and both sizes), not an assert that -O strips
    if size < len(a):
        raise FlatLFVTError(
            f"pad_flat_tables: cap {size} for {name!r} is below the "
            f"current size {len(a)} — flat-table caps must not shrink")
    return np.concatenate(
        [a, np.full(size - len(a), fill, a.dtype)]).astype(a.dtype)


def pad_flat_tables(flat: FlatLFVT, *, n_nodes: int | None = None,
                    n_seq: int | None = None, n_entries: int | None = None,
                    n_sets: int | None = None,
                    max_seq_len: int | None = None) -> FlatLFVT:
    """Sentinel-pad the flat tables to the given caps (each defaults to
    the current size; must not shrink). Returns a new ``FlatLFVT`` whose
    walks are bit-identical to the original — the sentinel rows are
    unreachable by construction:

      * entry rows: ``entry_elem`` = int32 max (keeps the table sorted;
        never equals a real element id), ``entry_len`` = 0;
      * seq rows: ``seq_row`` = 0 / ``seq_next`` = -1 — no real entry
        position or hop chain ever points past the original T;
      * node rows: empty sequence, parent -1, child/owner CSRs extended
        with empty slices;
      * set rows: ``s_sizes`` = 0 (outside every real [lo, hi) window
        and f > 0 can never hold), ``s_ids`` = -1.

    ``max_seq_len`` may be raised past the true bound; the walk stops
    once its lanes are dead, so the extra bound costs nothing.
    """
    caps = flat_walk_caps(flat)
    n_nodes = caps["n_nodes"] if n_nodes is None else n_nodes
    n_seq = caps["n_seq"] if n_seq is None else n_seq
    n_entries = caps["n_entries"] if n_entries is None else n_entries
    n_sets = caps["n_sets"] if n_sets is None else n_sets
    max_seq_len = (caps["max_seq_len"] if max_seq_len is None
                   else max(max_seq_len, caps["max_seq_len"]))
    return FlatLFVT(
        node_seq_off=_pad1(flat.node_seq_off, n_nodes, 0, "n_nodes"),
        node_seq_len=_pad1(flat.node_seq_len, n_nodes, 0, "n_nodes"),
        node_parent=_pad1(flat.node_parent, n_nodes, -1, "n_nodes"),
        child_indptr=_pad1(flat.child_indptr, n_nodes + 1,
                           flat.child_indptr[-1], "n_nodes"),
        child_ids=flat.child_ids,
        owner_indptr=_pad1(flat.owner_indptr, n_nodes + 1,
                           flat.owner_indptr[-1], "n_nodes"),
        owner_elems=flat.owner_elems,
        seq_row=_pad1(flat.seq_row, n_seq, 0, "n_seq"),
        seq_next=_pad1(flat.seq_next, n_seq, -1, "n_seq"),
        entry_elem=_pad1(flat.entry_elem, n_entries, PAD_SENTINEL,
                         "n_entries"),
        entry_node=_pad1(flat.entry_node, n_entries, 0, "n_entries"),
        entry_off=_pad1(flat.entry_off, n_entries, 0, "n_entries"),
        entry_len=_pad1(flat.entry_len, n_entries, 0, "n_entries"),
        s_ids=_pad1(flat.s_ids, n_sets, -1, "n_sets"),
        s_sizes=_pad1(flat.s_sizes, n_sets, 0, "n_sets"),
        universe=flat.universe, max_seq_len=max_seq_len)


# ---------------------------------------------------------------------- #
# incremental encoding: append sets without the pointer-tree rebuild
# ---------------------------------------------------------------------- #
def _pow2_cap(n: int, grain: int = 1) -> int:
    """Smallest power-of-two multiple of ``grain`` >= max(n, grain)."""
    cap = max(int(grain), 1)
    while cap < n:
        cap <<= 1
    return cap


class IncrementalLFVT:
    """Append-only wrapper growing a :class:`FlatLFVT` in place.

    ``append(new_sets)`` admits sets into an existing flat table without
    the full ``LFVT(S)`` pointer-tree rebuild: the seq/entry/``seq_next``
    arrays live inside power-of-two capacity buffers (padded with the
    ``pad_flat_tables`` sentinels), and each append touches only the
    element chains the new sets intersect. Every array equals the JAX
    package's ``IncrementalLFVT`` after the same appends.

    Layout — the *stable-row* scheme. Rows ``[0, n_base)`` keep the
    size-descending order of the initial encode; appended sets take rows
    at the live tail ``[n_base, n_live)`` in admission order, so no
    existing ``seq_row`` is renumbered. :meth:`window_bounds` computes
    the Lemma-3.1 windows over the sorted base prefix and widens them
    over the whole live tail: a superset of the qualify support, so
    masks equal a from-scratch encode of the grown collection (modulo
    its column order), and the Theorem-3.3 early stop stays safe.

    Per touched element ``a`` the chain update takes one of two paths:

      * **prepend fast path** — every new tuple is no larger than the
        current walk head and L(a) sits at the end of its node: the new
        tuples become one fresh run node whose ``seq_next`` chains into
        the old entry position (parent = the old entry node);
      * **chain re-encode fallback** — otherwise the merged ``seq(a)``
        (old tuples size-desc + new tuples spliced in size order,
        old-before-new on ties) is re-emitted as one fresh root-child
        run; the old positions become garbage until :meth:`compact`.

    Either way the cost is Σ|seq(a)| over *touched* chains plus the new
    tuples — never O(corpus) — tracked in ``stats``. Chains are read and
    merged with numpy (one slice per contiguous run). Every append
    drops the view's device uploads (``FlatLFVT.to_device``), so the
    next walk uploads the grown table; a regrow swaps in a new view and
    leaves the old one, uploads included, untouched.
    """

    def __init__(self, S: SetCollection | None = None, *,
                 universe: int | None = None, capacity_grain: int = 64):
        if S is None:
            if universe is None:
                raise ValueError(
                    "IncrementalLFVT needs an initial collection or an "
                    "explicit universe")
            S = SetCollection.from_ragged([], universe=universe)
        S.validate()
        self.universe = max(int(S.universe), int(universe or 0))
        self.grain = int(capacity_grain)
        Ss = S if S.sorted_by_size else S.sort_by_size()
        if self.universe != Ss.universe:
            Ss = SetCollection(Ss.sets, self.universe, Ss.ids,
                               sorted_by_size=True)
        base = encode(Ss)
        # the ragged live collection (compact()/rebuild reference), in
        # row order: sorted base prefix + admission-ordered tail
        self._sets: list[np.ndarray] = [np.asarray(s, np.int32)
                                        for s in Ss.sets]
        self._ids: list[int] = [int(i) for i in Ss.ids]
        self._next_id = max(self._ids, default=-1) + 1
        # live extents inside the capacity arrays
        self.n_base = base.n_sets
        self.n_live = base.n_sets
        self.t_live = len(base.seq_row)
        self.e_live = len(base.entry_elem)
        self.nodes_live = base.n_nodes
        self.seq_max_live = int(base.max_seq_len)
        self.version = 0
        self.stats = {"appends": 0, "appended_sets": 0, "appended_tuples": 0,
                      "touched_chain_tuples": 0, "prepend_fast_path": 0,
                      "merged_chains": 0, "new_elements": 0, "regrows": 0}
        self._flat = self._padded_view(base)

    # -------------------------------------------------------------- #
    @property
    def flat(self) -> FlatLFVT:
        """The current capacity view (re-fetch after every append: an
        append that regrows capacity swaps in a new object)."""
        return self._flat

    @property
    def append_work(self) -> int:
        """Total seq slots written by appends so far: Σ touched-chain
        tuples + Σ appended tuples."""
        return (self.stats["appended_tuples"]
                + self.stats["touched_chain_tuples"])

    def collection(self) -> SetCollection:
        """The live corpus as a plain collection (rebuild reference)."""
        ids = np.asarray(self._ids, np.int32)
        return SetCollection(list(self._sets), self.universe, ids,
                             sorted_by_size=False)

    def window_bounds(self, r_sizes, t: float, measure: str = "jaccard"):
        """Per-row [lo, hi) column windows valid for this layout:
        Lemma 3.1 over the sorted base prefix, widened over the
        (unsorted) appended tail."""
        from .tile_join import window_bounds as _wb  # cyclic at import
        base_desc = np.asarray(
            self._flat.s_sizes[:self.n_base], dtype=np.int64)
        lo, hi = _wb(np.asarray(r_sizes, dtype=np.int64), base_desc, t,
                     measure)
        if self.n_live > self.n_base:
            hi = np.full_like(hi, self.n_live)
        return lo, hi

    # -------------------------------------------------------------- #
    def _padded_view(self, flat: FlatLFVT,
                     max_seq_len: int | None = None) -> FlatLFVT:
        g = self.grain
        out = pad_flat_tables(
            flat,
            n_nodes=_pow2_cap(flat.n_nodes, g),
            n_seq=_pow2_cap(len(flat.seq_row), g),
            n_entries=_pow2_cap(len(flat.entry_elem), g),
            n_sets=_pow2_cap(flat.n_sets, g),
            max_seq_len=max(_pow2_cap(flat.max_seq_len, 1),
                            max_seq_len or 0))
        out.universe = self.universe
        return out

    def _live_flat(self) -> FlatLFVT:
        """Slice the live prefixes out of the capacity arrays."""
        f = self._flat
        N, T = self.nodes_live, self.t_live
        E, n = self.e_live, self.n_live
        return FlatLFVT(
            node_seq_off=f.node_seq_off[:N], node_seq_len=f.node_seq_len[:N],
            node_parent=f.node_parent[:N],
            child_indptr=f.child_indptr[:N + 1], child_ids=f.child_ids,
            owner_indptr=f.owner_indptr[:N + 1], owner_elems=f.owner_elems,
            seq_row=f.seq_row[:T], seq_next=f.seq_next[:T],
            entry_elem=f.entry_elem[:E], entry_node=f.entry_node[:E],
            entry_off=f.entry_off[:E], entry_len=f.entry_len[:E],
            s_ids=f.s_ids[:n], s_sizes=f.s_sizes[:n],
            universe=self.universe, max_seq_len=self.seq_max_live)

    def _ensure_capacity(self, n_rows: int, n_slots: int, n_nodes: int,
                         n_entries: int) -> None:
        f = self._flat
        if (self.n_live + n_rows <= f.n_sets
                and self.t_live + n_slots <= len(f.seq_row)
                and self.nodes_live + n_nodes <= f.n_nodes
                and self.e_live + n_entries <= len(f.entry_elem)):
            return
        # regrow: repad the live slices into doubled capacity buffers.
        # The old view object is left untouched, so a stale device
        # upload of it keeps serving the pre-regrow corpus.
        g = self.grain
        grown = pad_flat_tables(
            self._live_flat(),
            n_nodes=_pow2_cap(self.nodes_live + n_nodes, g),
            n_seq=_pow2_cap(self.t_live + n_slots, g),
            n_entries=_pow2_cap(self.e_live + n_entries, g),
            n_sets=_pow2_cap(self.n_live + n_rows, g),
            max_seq_len=f.max_seq_len)
        grown.universe = self.universe
        self._flat = grown
        self.stats["regrows"] += 1

    def _entry_index(self, a: int) -> int | None:
        f = self._flat
        i = int(np.searchsorted(f.entry_elem[:self.e_live], a))
        if i < self.e_live and int(f.entry_elem[i]) == a:
            return i
        return None

    def _read_chain(self, pos: int, length: int) -> np.ndarray:
        """Rows of a chain in walk order (size asc) via the fused hop,
        one numpy slice per run of positions the hop walks down by one."""
        f = self._flat
        parts = []
        while length > 0:
            p = np.arange(pos, max(pos - length, -1), -1)
            brk = np.flatnonzero(f.seq_next[p] != p - 1)
            n = int(brk[0]) + 1 if len(brk) else len(p)
            parts.append(f.seq_row[pos - n + 1:pos + 1][::-1])
            length -= n
            pos = int(f.seq_next[pos - n + 1])
        return (np.concatenate(parts) if parts
                else np.zeros(0, f.seq_row.dtype))

    def _rebuild_csrs(self) -> None:
        """Recompute the child/owner CSRs over the live prefix (decode
        metadata only — the walk never reads them)."""
        f = self._flat
        N = self.nodes_live
        par = f.node_parent[1:N].astype(np.int64)
        kids = np.arange(1, N, dtype=np.int32)
        f.child_ids = kids[np.argsort(par, kind="stable")]
        indptr = np.concatenate(
            [[0], np.cumsum(np.bincount(par, minlength=N))]).astype(np.int32)
        f.child_indptr[:N + 1] = indptr
        f.child_indptr[N + 1:] = indptr[-1]
        live = f.entry_len[:self.e_live] > 0
        en = f.entry_node[:self.e_live][live].astype(np.int64)
        ee = f.entry_elem[:self.e_live][live]
        f.owner_elems = ee[np.lexsort((ee, en))].astype(np.int32)
        optr = np.concatenate(
            [[0], np.cumsum(np.bincount(en, minlength=N))]).astype(np.int32)
        f.owner_indptr[:N + 1] = optr
        f.owner_indptr[N + 1:] = optr[-1]

    # -------------------------------------------------------------- #
    def append(self, new_sets) -> np.ndarray:
        """Admit ``new_sets`` (ragged element lists) into the table;
        returns their assigned external ids (contiguous, increasing)."""
        from .sets import CollectionValidationError, _as_ragged
        ragged = _as_ragged(new_sets)
        for i, s in enumerate(ragged):
            if len(s) and s[0] < 0:
                raise CollectionValidationError(
                    f"append set {i}: negative element id {int(s[0])}")
            if len(s) and int(s[-1]) >= self.universe:
                raise CollectionValidationError(
                    f"append set {i}: element id {int(s[-1])} outside "
                    f"universe [0, {self.universe})")
        k = len(ragged)
        ids = np.arange(self._next_id, self._next_id + k, dtype=np.int32)
        if k == 0:
            return ids
        sizes = np.asarray([len(s) for s in ragged], np.int64)

        # group the new tuples per element in seq order: size desc, id
        # asc (ids are assigned in submission order, so row order works)
        touched: dict[int, list[int]] = {}
        for bi in np.lexsort((np.arange(k), -sizes)):
            for a in ragged[bi]:
                touched.setdefault(int(a), []).append(int(bi))

        # plan each touched chain before any write so one capacity check
        # covers the whole batch
        f = self._flat
        plans = []  # (elem, mode, batch idxs, extra)
        total_slots = 0
        n_new_elems = 0
        for a, bis in touched.items():
            e = self._entry_index(a)
            if e is None:
                plans.append((a, "new", bis, None))
                total_slots += len(bis)
                n_new_elems += 1
                continue
            old_node = int(f.entry_node[e])
            old_off = int(f.entry_off[e])
            old_len = int(f.entry_len[e])
            old_pos = int(f.node_seq_off[old_node]) + old_off
            head_size = int(f.s_sizes[int(f.seq_row[old_pos])])
            at_node_end = old_off == int(f.node_seq_len[old_node]) - 1
            if at_node_end and int(max(sizes[bi] for bi in bis)) <= head_size:
                plans.append((a, "prepend", bis, (old_node, old_pos,
                                                  old_len)))
                total_slots += len(bis)
            else:
                plans.append((a, "merge", bis, (old_pos, old_len)))
                total_slots += old_len + len(bis)

        self._ensure_capacity(n_rows=k, n_slots=total_slots,
                              n_nodes=len(plans), n_entries=n_new_elems)
        f = self._flat  # may be a fresh view after a regrow

        rows = self.n_live + np.arange(k, dtype=np.int64)
        f.s_ids[self.n_live:self.n_live + k] = ids
        f.s_sizes[self.n_live:self.n_live + k] = sizes

        # sorted in-place insertion of brand-new element entries (one
        # multi-insert pass per column; values land in the chain loop)
        new_elems = np.sort(np.asarray(
            [a for a, mode, _, _ in plans if mode == "new"], np.int32))
        if len(new_elems):
            at = np.searchsorted(f.entry_elem[:self.e_live], new_elems)
            e2 = self.e_live + len(new_elems)
            for col, val in ((f.entry_elem, new_elems), (f.entry_node, 0),
                             (f.entry_off, 0), (f.entry_len, 0)):
                col[:e2] = np.insert(col[:self.e_live], at, val)
            self.e_live = e2
            self.stats["new_elements"] += len(new_elems)

        for a, mode, bis, extra in plans:
            t0 = self.t_live
            new_rows = rows[bis].astype(np.int32)
            if mode == "merge":
                old_pos, old_len = extra
                old_seq = self._read_chain(old_pos, old_len)[::-1]
                # splice by size desc, old first on ties (id asc): both
                # runs are size-desc, so new row j lands after every old
                # row at least as large
                old_sz = f.s_sizes[old_seq]
                at = (np.searchsorted(-old_sz, -f.s_sizes[new_rows],
                                      side="right")
                      + np.arange(len(new_rows)))
                run = np.empty(old_len + len(new_rows), np.int32)
                is_new = np.zeros(len(run), bool)
                is_new[at] = True
                run[is_new] = new_rows
                run[~is_new] = old_seq
                hop0, parent, entry_len = -1, 0, len(run)
                self.stats["touched_chain_tuples"] += old_len
                self.stats["merged_chains"] += 1
            elif mode == "prepend":
                old_node, old_pos, old_len = extra
                run = new_rows
                hop0, parent = old_pos, old_node
                entry_len = old_len + len(run)
                self.stats["prepend_fast_path"] += 1
            else:
                run = new_rows
                hop0, parent, entry_len = -1, 0, len(run)
            L = len(run)
            f.seq_row[t0:t0 + L] = run
            f.seq_next[t0] = hop0
            f.seq_next[t0 + 1:t0 + L] = np.arange(t0, t0 + L - 1,
                                                  dtype=np.int32)
            nid = self.nodes_live
            f.node_seq_off[nid] = t0
            f.node_seq_len[nid] = L
            f.node_parent[nid] = parent
            e = self._entry_index(a)
            f.entry_node[e] = nid
            f.entry_off[e] = L - 1
            f.entry_len[e] = entry_len
            self.t_live += L
            self.nodes_live += 1
            self.seq_max_live = max(self.seq_max_live, entry_len)
            self.stats["appended_tuples"] += len(bis)

        if self.seq_max_live > f.max_seq_len:
            # raise the static walk bound in pow-2 jumps
            f.max_seq_len = _pow2_cap(self.seq_max_live, 1)
        self._rebuild_csrs()
        self.n_live += k
        self._sets.extend(ragged)
        self._ids.extend(int(i) for i in ids)
        self._next_id += k
        f._device.clear()  # host arrays mutated: drop every upload
        self.version += 1
        self.stats["appends"] += 1
        self.stats["appended_sets"] += k
        return ids

    def compact(self) -> FlatLFVT:
        """Full re-encode of the live corpus: reclaims garbage chain
        positions, restores the global size sort (``n_base == n_live``),
        and resets capacity slack. Returns the fresh view."""
        S = self.collection().sort_by_size()
        self._sets = [np.asarray(s, np.int32) for s in S.sets]
        self._ids = [int(i) for i in S.ids]
        base = encode(S)
        self.n_base = self.n_live = base.n_sets
        self.t_live = len(base.seq_row)
        self.e_live = len(base.entry_elem)
        self.nodes_live = base.n_nodes
        self.seq_max_live = int(base.max_seq_len)
        self._flat = self._padded_view(base)
        self.version += 1
        return self._flat


# ---------------------------------------------------------------------- #
# whole-block array walk (the reference's ``lfvt_ref`` path)
# ---------------------------------------------------------------------- #
def _walk_counts(dev: FlatLFVTDevice, r_padded: torch.Tensor,
                 col_lo: torch.Tensor, *, max_steps: int) -> torch.Tensor:
    """(mb, Lr) padded R element lists -> (mb, n) int32 overlap counts.

    Every (row, element) lane walks its L(a)->root path in lockstep;
    exhausted or early-stopped lanes are parked at the root and add 0.
    The loop ends early once every lane is dead: later steps would add
    nothing, so the counts equal the reference's fixed-length loop.
    """
    mb, Lr = r_padded.shape
    n = dev.s_sizes.shape[0]
    E = dev.entry_elem.shape[0]
    counts = torch.zeros((mb, n), dtype=torch.int32, device=r_padded.device)
    if E == 0:
        return counts
    a = r_padded.to(torch.int32)
    # sparse entry lookup: binary search over the sorted present elements
    idx = torch.clamp(torch.searchsorted(dev.entry_elem, a), max=E - 1)
    present = (a >= 0) & (dev.entry_elem[idx] == a)
    zero = torch.zeros((), dtype=torch.int32, device=a.device)
    rem = torch.where(present, dev.entry_len[idx], zero)
    off = torch.where(present, dev.entry_off[idx], zero)
    node = torch.where(present, dev.entry_node[idx], zero).long()
    row_ix = torch.arange(mb, device=a.device)[:, None].expand(mb, Lr)
    lo_b = col_lo.to(torch.int32)[:, None]
    for _ in range(max_steps):
        active = rem > 0
        if not bool(active.any()):
            break
        pos = (dev.node_seq_off[node] + off).long()
        row = dev.seq_row[torch.where(active, pos, 0)]
        counts.index_put_((row_ix, torch.where(active, row, zero).long()),
                          active.to(torch.int32), accumulate=True)
        # window early stop (Theorem 3.3): walk rows strictly decrease,
        # so once row < lo every deeper-rootward set is oversized too
        rem = torch.where(active & (row >= lo_b), rem - 1, zero)
        off = off - 1
        up = off < 0
        par = torch.clamp(dev.node_parent[node], min=0).long()
        off = torch.where(up, dev.node_seq_len[par] - 1, off)
        node = torch.where(up, par, node)
        dead = rem <= 0  # park: keep gather indices in bounds
        node = torch.where(dead, 0, node)
        off = torch.where(dead, zero, torch.clamp(off, min=0))
    return counts


def flat_join_mask(flat: FlatLFVT, r_padded, r_sizes, lo, hi, t: float,
                   measure: str = "jaccard", device=None) -> torch.Tensor:
    """(mb, n) bool qualifying mask of an R block against the flat LFVT.

    ``r_padded`` is the (mb, Lr) -1-padded element-list layout
    (``SetCollection.padded``); columns are rows of the size-sorted S the
    tree was encoded over, with the usual [lo, hi) windows applied. The
    walk runs on ``r_padded``'s device when it is a tensor, else on
    ``device`` (which then must be given).
    """
    if torch.is_tensor(r_padded):
        device = r_padded.device
    elif device is None:
        raise ValueError("flat_join_mask: pass device= with host inputs")
    dev = flat.to_device(device)

    def col(x):
        if torch.is_tensor(x):
            return x.to(device=device, dtype=torch.int32)
        return torch.tensor(np.asarray(x), dtype=torch.int32, device=device)

    r_pad = col(r_padded)
    r_sz, lo_t, hi_t = col(r_sizes), col(lo), col(hi)
    counts = _walk_counts(dev, r_pad, lo_t, max_steps=flat.max_seq_len)
    cols = torch.arange(dev.s_sizes.shape[0], dtype=torch.int32,
                        device=device)[None, :]
    in_window = (cols >= lo_t[:, None]) & (cols < hi_t[:, None])
    return measures.device_qualify(counts, r_sz[:, None],
                                   dev.s_sizes[None, :], t,
                                   measure) & in_window
