"""The port's device mesh: one process driving a list of torch devices.

The counterpart of the JAX package's ``launch/mesh.py``. A JAX ``Mesh``
is one process driving many devices along named axes; so is this one,
with a single axis (``"data"``, the MapReduce driver's shard axis) whose
slots are torch devices. Slots may repeat a device: on one card,
``make_host_mesh(8)`` gives 8 slots on ``cuda:0``, and the shards that
share it run in turn on its stream (the counterpart of the reference's
forced host devices). ``torch.distributed`` is not used: the mesh path
stays one call in one process, as the reference's ``shard_map`` is.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.device import resolve_device
from ..errors import MeshTypeError

__all__ = ["Mesh", "make_host_mesh", "check_mesh"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices`` (one torch device per slot) along the one axis
    ``axis_names[0]``; ``shape[axis]`` and ``devices`` read as a JAX
    mesh's do. Every slot is resolved on construction, so a CUDA slot
    without a visible card raises ``DeviceUnavailableError``."""

    devices: tuple
    axis_names: tuple = ("data",)

    def __post_init__(self):
        devs = tuple(resolve_device(d) for d in self.devices)
        if not devs:
            raise ValueError("a Mesh needs at least one device slot")
        names = tuple(self.axis_names)
        if len(names) != 1:
            raise ValueError(f"the port's Mesh has one axis, got "
                             f"axis_names={names!r}")
        object.__setattr__(self, "devices", devs)
        object.__setattr__(self, "axis_names", names)

    @property
    def shape(self) -> dict:
        return {self.axis_names[0]: len(self.devices)}


def make_host_mesh(data: int | None = None, device=None) -> Mesh:
    """A ``data``-slot mesh over the visible cards, slots placed round
    robin (slot ``k`` on card ``k % count``); ``data`` defaults to the
    number of cards. ``device="cpu"`` puts every slot on the CPU (one
    slot by default); a named card (``"cuda:1"``) takes every slot."""
    dev = resolve_device(device)
    if dev.type == "cpu" or dev.index is not None:
        return Mesh((dev,) * (data or 1))
    count = torch.cuda.device_count()
    return Mesh(tuple(torch.device("cuda", k % count)
                      for k in range(data or count)))


def check_mesh(mesh) -> Mesh:
    """``mesh`` itself when it is the port's :class:`Mesh`; anything else
    (a ``jax.sharding.Mesh`` included) raises :class:`MeshTypeError`."""
    if not isinstance(mesh, Mesh):
        raise MeshTypeError(
            f"mesh= takes a repro_torch.launch.mesh.Mesh (see "
            f"make_host_mesh), got {type(mesh).__module__}."
            f"{type(mesh).__qualname__}")
    return mesh
