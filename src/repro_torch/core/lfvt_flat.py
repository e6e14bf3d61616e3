"""Flat-array Linear FVT: the LFVT encoding as linear int32 arrays plus
the whole-block array walk, in PyTorch.

The port of the JAX package's ``core/lfvt_flat.py``. ``encode`` (numpy,
byte-for-byte the reference's encoder) compiles the pointer-based
``LFVT`` (core/fvt.py) into CSR-style int32 arrays; ``to_device``
uploads the arrays the walk reads as torch tensors, once per device;
``from_arrays`` rebuilds a table from the reference's ``arrays()`` so a
table encoded by either package can feed the other's walk.

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

__all__ = ["FlatLFVT", "FlatLFVTDevice", "FlatLFVTError", "encode",
           "flat_join_mask"]


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
        FlatLFVT itself alive)."""
        device = torch.device(device)
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
