"""Tensors placed on the slots of a mesh: the port's global arrays.

A :class:`Sharded` is one logical tensor (its global ``shape``) held as
one piece per slot of a mesh, as its :class:`~.rules.Placement` says: the
counterpart of a ``jax.Array`` with a ``NamedSharding``. ``shard`` cuts
a whole tensor into the pieces and ``unshard`` puts them back. Slots
that hold the same piece on the same device share one tensor; a piece
smaller than the whole is its own copy, so it does not keep the whole
tensor's storage alive.
"""
from __future__ import annotations

import dataclasses

import torch

from .rules import Placement

__all__ = ["Sharded", "shard", "unshard"]


@dataclasses.dataclass(frozen=True, eq=False)
class Sharded:
    placement: Placement
    shape: tuple      # the logical (global) shape
    shards: tuple     # one tensor per slot, in slot order

    @property
    def mesh(self):
        return self.placement.mesh

    @property
    def spec(self) -> tuple:
        return self.placement.spec

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    def owned(self) -> list:
        """(slot, piece) for the one owner of each distinct piece."""
        return [(s, x) for s, x in enumerate(self.shards)
                if self.placement.is_owner(s)]


def shard(x: torch.Tensor, placement: Placement) -> Sharded:
    """``x`` cut into ``placement``'s pieces, each on its slot's device
    (a ``meta`` slot or a ``meta`` ``x`` gives ``meta`` pieces)."""
    mesh, shape = placement.mesh, tuple(x.shape)
    local = placement.local_shape(shape)
    whole = local == shape
    made: dict = {}
    out = []
    for s, dev in enumerate(mesh.devices):
        idx = placement.slices(shape, s)
        key = (str(dev), tuple((i.start, i.stop) for i in idx))
        if key not in made:
            if dev.type == "meta" or x.is_meta:
                made[key] = torch.empty(local, dtype=x.dtype, device="meta")
            elif whole:
                made[key] = x.to(dev)
            else:
                made[key] = x[idx].to(dev, copy=True).contiguous()
        out.append(made[key])
    return Sharded(placement, shape, tuple(out))


def unshard(x: Sharded, device=None) -> torch.Tensor:
    """The whole tensor from its owners' pieces, on ``device`` (default:
    the first slot's)."""
    p = x.placement
    dev = x.shards[0].device if device is None else torch.device(device)
    if p.local_shape(x.shape) == x.shape:
        return x.shards[0].to(dev)
    full = torch.empty(x.shape, dtype=x.dtype, device=dev)
    for s, piece in x.owned():
        full[p.slices(x.shape, s)] = piece.to(dev)
    return full
