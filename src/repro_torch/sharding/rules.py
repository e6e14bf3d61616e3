"""Logical-axis sharding rules (MaxText-style) for the LM substrate.

The port of the JAX package's ``sharding/rules.py``. Every parameter and
activation carries *logical* axis names; a rules table maps each to mesh
axes. Divisibility is checked at resolution time: a logical axis whose
size does not divide its mesh axes falls back to replication (or raises,
with ``strict=True``).

A spec is the port's own small ``PartitionSpec``: a tuple with one entry
per dimension, each ``None`` (replicated), a mesh axis name, or a tuple
of axis names (split over their product, the first axis major). A
:class:`Placement` is a spec on a mesh (the reference's
``NamedSharding``): it says which piece of a tensor each slot holds.

Mesh axes (launch/mesh.py):
  pod    hierarchical data parallelism across pods (multi-pod mesh only)
  data   data parallelism (+ ZeRO-1 optimizer sharding, FSDP when enabled)
  model  tensor/expert parallelism
"""
from __future__ import annotations

import dataclasses

__all__ = ["Rules", "DEFAULT_RULES", "Placement", "logical_to_spec",
           "named_sharding", "pad_to_multiple", "axis_size", "entry_axes"]

# logical axis -> tuple of mesh axes (tried in order; all must exist+divide)
DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),       # global batch over pod x data
    "seq": (),                      # replicated by default; SP uses "seq_sharded"
    "seq_sharded": ("data",),       # sequence parallelism (long-context prefill)
    "embed": (),                    # d_model replicated
    "embed_fsdp": ("data",),        # FSDP: shard big weights' embed dim on data
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": (),
    "mlp": ("model",),
    "experts": ("model",),
    "expert_mlp": (),
    "vocab": ("model",),
    "layers": (),                   # the layer stack, never sharded
    "state": ("model",),            # recurrent state feature dim
    "capacity": (),
}


@dataclasses.dataclass(frozen=True)
class Rules:
    table: tuple  # tuple of (logical, mesh axes) for hashability

    @classmethod
    def default(cls, fsdp: bool = False) -> "Rules":
        t = dict(DEFAULT_RULES)
        t["embed_fsdp"] = ("data",) if fsdp else ()
        return cls(tuple(sorted((k, tuple(v)) for k, v in t.items())))

    def lookup(self, logical: str) -> tuple[str, ...]:
        for k, v in self.table:
            if k == logical:
                return v
        raise KeyError(f"unknown logical axis {logical!r}")


def axis_size(mesh, axes: tuple[str, ...]) -> int:
    """The product of the sizes of ``axes`` that ``mesh`` has."""
    n = 1
    for a in axes:
        if a in mesh.shape:
            n *= mesh.shape[a]
    return n


def entry_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry: () for None, (name,) for a name."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def logical_to_spec(mesh, rules: Rules, logical_axes: tuple,
                    sizes: tuple | None = None,
                    strict: bool = False) -> tuple:
    """Resolve logical axes -> a spec tuple, with divisibility fallback.

    Reads only ``mesh.shape`` (an ordered mapping of axis -> size), so a
    shape-only mesh serves as well as a placed one. A mesh axis is used
    at most once per spec."""
    entries = []
    used: set[str] = set()
    for i, name in enumerate(logical_axes):
        if name is None:
            entries.append(None)
            continue
        mesh_axes = tuple(a for a in rules.lookup(name)
                          if a in mesh.shape and a not in used)
        if not mesh_axes:
            entries.append(None)
            continue
        if sizes is not None:
            n = axis_size(mesh, mesh_axes)
            if sizes[i] % n != 0:
                if strict:
                    raise ValueError(
                        f"axis {name!r} size {sizes[i]} not divisible by mesh "
                        f"{mesh_axes} ({n}); pad or change rules")
                entries.append(None)  # replicate fallback
                continue
        used.update(mesh_axes)
        entries.append(mesh_axes if len(mesh_axes) > 1 else mesh_axes[0])
    return tuple(entries)


@dataclasses.dataclass(frozen=True)
class Placement:
    """A spec on a mesh: slot ``s`` holds, along each dimension ``i``,
    piece ``k`` of ``n`` equal pieces, where ``n`` is the product of the
    sizes of ``spec[i]``'s axes and ``k`` the slot's index along them
    (row-major, the first axis major). Dimensions past the spec's length
    are replicated."""

    mesh: object
    spec: tuple

    def __post_init__(self):
        object.__setattr__(self, "spec", tuple(self.spec))
        for e in self.spec:
            for a in entry_axes(e):
                if a not in self.mesh.shape:
                    raise ValueError(f"spec {self.spec} names axis {a!r}, "
                                     f"which the mesh {dict(self.mesh.shape)} "
                                     "lacks")

    def axes(self) -> set:
        """Every mesh axis the spec splits on."""
        return {a for e in self.spec for a in entry_axes(e)}

    def pieces(self, dim: int) -> int:
        """How many pieces dimension ``dim`` is cut into."""
        if dim >= len(self.spec):
            return 1
        return axis_size(self.mesh, entry_axes(self.spec[dim]))

    def piece_index(self, dim: int, slot: int) -> int:
        """Which piece of dimension ``dim`` slot ``slot`` holds."""
        if dim >= len(self.spec):
            return 0
        coords = self.mesh.coords(slot)
        k = 0
        for a in entry_axes(self.spec[dim]):
            k = k * self.mesh.shape[a] + coords[a]
        return k

    def local_shape(self, shape: tuple) -> tuple:
        out = []
        for i, n in enumerate(shape):
            p = self.pieces(i)
            if n % p:
                raise ValueError(f"dimension {i} of {tuple(shape)} does not "
                                 f"divide into {p} pieces (spec "
                                 f"{self.spec})")
            out.append(n // p)
        return tuple(out)

    def slices(self, shape: tuple, slot: int) -> tuple:
        """The index (a tuple of slices) of slot ``slot``'s piece of a
        tensor of ``shape``."""
        local = self.local_shape(shape)
        return tuple(slice(self.piece_index(i, slot) * m,
                           (self.piece_index(i, slot) + 1) * m)
                     for i, m in enumerate(local))

    def is_owner(self, slot: int) -> bool:
        """True for the one slot among those holding the same piece that
        sits at coordinate 0 of every axis the spec does not split on."""
        used = self.axes()
        coords = self.mesh.coords(slot)
        return all(c == 0 for a, c in coords.items() if a not in used)


def named_sharding(mesh, rules: Rules, logical_axes, sizes=None,
                   strict: bool = False) -> Placement:
    return Placement(mesh, logical_to_spec(mesh, rules, logical_axes,
                                           sizes, strict))


def pad_to_multiple(n: int, mult: int) -> int:
    return -(-n // mult) * mult
