"""The port's device mesh: one process driving a grid of torch devices.

The counterpart of the JAX package's ``launch/mesh.py``. A JAX ``Mesh``
is one process driving many devices along named axes; so is this one,
whose slots sit in a grid over ``axis_names`` (row-major: the last axis
varies fastest) and each name a torch device. Slots may repeat a
device: on one card, ``make_host_mesh(8)`` gives 8 slots on ``cuda:0``,
and the work of the slots that share it runs in turn on its stream (the
counterpart of the reference's forced host devices).
``torch.distributed`` is not used: NCCL refuses two ranks on one GPU, so
a process group could not run several slots on one card, and the mesh
path stays one call in one process, as the reference's ``shard_map`` and
``pjit`` are. Collectives over a mesh axis are ``sharding/collectives``.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..core.device import resolve_device
from ..errors import MeshTypeError

__all__ = ["Mesh", "make_host_mesh", "make_production_mesh", "check_mesh",
           "join_axis"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices`` (one torch device per slot, flat, row-major) on a grid
    of ``sizes`` over ``axis_names``; ``sizes`` defaults to every slot on
    the first axis and 1 on the others. ``shape`` (an ordered axis ->
    size dict), ``axis_names`` and ``devices`` read as a JAX mesh's do.
    Every slot is resolved on construction, so a CUDA slot without a
    visible card raises ``DeviceUnavailableError``; ``"meta"`` slots make
    an abstract mesh (for shapes and placements only)."""

    devices: tuple
    axis_names: tuple = ("data",)
    sizes: tuple | None = None

    def __post_init__(self):
        devs = tuple(_resolve(d) for d in self.devices)
        if not devs:
            raise ValueError("a Mesh needs at least one device slot")
        names = tuple(self.axis_names)
        if not names or len(set(names)) != len(names):
            raise ValueError(f"a Mesh needs distinct axis names, got "
                             f"{names!r}")
        sizes = (tuple(int(s) for s in self.sizes) if self.sizes is not None
                 else (len(devs),) + (1,) * (len(names) - 1))
        if len(sizes) != len(names) or math.prod(sizes) != len(devs):
            raise ValueError(f"mesh sizes {sizes} over {names} do not hold "
                             f"{len(devs)} slots")
        object.__setattr__(self, "devices", devs)
        object.__setattr__(self, "axis_names", names)
        object.__setattr__(self, "sizes", sizes)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return len(self.devices)

    def coords(self, slot: int) -> dict:
        """Slot ``slot``'s coordinate on each axis."""
        out = {}
        for name, n in zip(reversed(self.axis_names), reversed(self.sizes)):
            slot, out[name] = divmod(slot, n)
        return {a: out[a] for a in self.axis_names}

    def groups(self, axes) -> list[list[int]]:
        """The slots that differ only along ``axes`` (names the mesh
        lacks are ignored), one list per group, each in the order of its
        combined index along ``axes`` (row-major); groups in slot
        order."""
        axes = tuple(a for a in axes if a in self.shape)
        out: dict = {}
        for s in range(self.size):
            c = self.coords(s)
            key = tuple(c[a] for a in self.axis_names if a not in axes)
            out.setdefault(key, []).append(s)
        return list(out.values())

    def axis_devices(self, axis: str) -> tuple:
        """The devices of the slots along ``axis`` at coordinate 0 of
        every other axis."""
        return tuple(self.devices[s] for s in self.groups((axis,))[0])


def _resolve(d) -> torch.device:
    if torch.device(d).type == "meta":
        return torch.device("meta")
    return resolve_device(d)


def make_host_mesh(data: int | None = None, device=None,
                   model: int = 1) -> Mesh:
    """A ``data``-slot mesh over the visible cards, slots placed round
    robin (slot ``k`` on card ``k % count``); ``data`` defaults to the
    number of cards. ``device="cpu"`` puts every slot on the CPU (one
    slot by default); a named card (``"cuda:1"``) takes every slot.
    ``model > 1`` adds a ``"model"`` axis: ``data x model`` slots over
    ``("data", "model")``."""
    dev = resolve_device(device)
    if dev.type == "cpu" or dev.index is not None:
        n = (data or 1) * model
        devs = (dev,) * n
    else:
        count = torch.cuda.device_count()
        n = (data or count) * model
        devs = tuple(torch.device("cuda", k % count) for k in range(n))
    if model == 1:
        return Mesh(devs)
    return Mesh(devs, ("data", "model"), (n // model, model))


def make_production_mesh(multi_pod: bool = False, device=None) -> Mesh:
    """16x16 over ``("data", "model")`` (one pod, 256 slots) or 2x16x16
    over ``("pod", "data", "model")`` (512 slots), as the reference's.
    ``device="meta"`` gives the abstract mesh of a dry run; otherwise the
    slots go round robin over the visible cards, or all on ``device``."""
    sizes = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(sizes)
    if device is not None and torch.device(device).type == "meta":
        devs = (torch.device("meta"),) * n
    else:
        dev = resolve_device(device)
        if dev.type == "cpu" or dev.index is not None:
            devs = (dev,) * n
        else:
            count = torch.cuda.device_count()
            devs = tuple(torch.device("cuda", k % count) for k in range(n))
    return Mesh(devs, axes, sizes)


def check_mesh(mesh) -> Mesh:
    """``mesh`` itself when it is the port's :class:`Mesh`; anything else
    (a ``jax.sharding.Mesh`` included) raises :class:`MeshTypeError`."""
    if not isinstance(mesh, Mesh):
        raise MeshTypeError(
            f"mesh= takes a repro_torch.launch.mesh.Mesh (see "
            f"make_host_mesh), got {type(mesh).__module__}."
            f"{type(mesh).__qualname__}")
    return mesh


def join_axis(mesh: Mesh, axis: str | None) -> str:
    """The axis a join's shards run along: ``axis``, else the one axis
    of a one-axis mesh, else ``"data"`` (the reference's
    ``global_config.mesh_axis``). The reference reads ``mesh.shape[axis]``
    and fails with a ``KeyError`` on a mesh without it; the port names
    the axis in a ``ValueError``."""
    if axis is None:
        axis = mesh.axis_names[0] if len(mesh.axis_names) == 1 else "data"
    if axis not in mesh.shape:
        raise ValueError(f"the mesh's {axis!r} axis does not exist (shape "
                         f"{mesh.shape}); pass axis= one of its axes")
    return axis
