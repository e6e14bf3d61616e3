"""Collectives over the slots of one mesh axis, in one process.

The port's mesh (``launch/mesh.Mesh``) is one process driving a grid of
slots, so a collective is an ordinary function of the per-slot tensors
of one group (the slots that differ only along the axis): plain
``.to(device)`` copies and adds, differentiable like any other torch
op, so that a backward pass through them is the collective's adjoint
(an ``all_reduce``'s backward is an ``all_reduce`` of the output
gradients, an ``all_gather``'s a ``reduce_scatter``). No
``torch.distributed``: NCCL refuses two ranks on one GPU.

Each function takes ``xs`` (one tensor per slot of the group, in the
group's order) and ``devices`` (each slot's device; default: each
tensor's own) and returns one tensor per slot on its device. The result
is computed once, on the first slot's device, and copied to each other
device once: slots that share a device share the result's storage (a
replicated tensor is never copied per slot on one card), and every
device holds the same bits. A group of one slot moves nothing and is not
counted.

``counter`` counts per kind the calls and the operand bytes, summed over
the group's slots (each slot's input once). It is the port's counterpart
of the reference's ``launch/analysis.collective_bytes_from_hlo``, which
reads the same per kind from the compiled program of one device: divide
by the slots of a group to compare. The one process runs a collective
once per group, so its calls count groups, where an SPMD program counts
one call for all groups.

``separate_slots()`` makes every slot its own device for these helpers,
whatever device it names: a dry run's slots all name ``meta``, yet stand
for one card each, so nothing is shared between them and each holds its
own copy of a collective's result (``launch/dryrun.py`` counts one
card's work so).
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

__all__ = ["CollectiveCounter", "counter", "all_reduce", "all_gather",
           "reduce_scatter", "all_to_all", "all_to_all_heads", "per_device",
           "per_piece", "distinct", "over_groups", "separate_slots", "KINDS"]

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all")


@dataclasses.dataclass
class CollectiveCounter:
    """Calls and operand bytes per collective kind since ``reset``."""

    calls: dict = dataclasses.field(
        default_factory=lambda: dict.fromkeys(KINDS, 0))
    bytes: dict = dataclasses.field(
        default_factory=lambda: dict.fromkeys(KINDS, 0))

    def reset(self) -> None:
        for k in KINDS:
            self.calls[k] = 0
            self.bytes[k] = 0

    def add(self, kind: str, xs) -> None:
        self.calls[kind] += 1
        self.bytes[kind] += sum(x.numel() * x.element_size() for x in xs)

    def snapshot(self) -> dict:
        """``{"bytes": {kind: n}, "calls": {kind: n}, "total": bytes}``."""
        return {"bytes": dict(self.bytes), "calls": dict(self.calls),
                "total": sum(self.bytes.values())}


counter = CollectiveCounter()
_separate = [False]


@contextlib.contextmanager
def separate_slots():
    """Within it, slots that name one device share nothing (see the
    module docstring)."""
    before = _separate[0]
    _separate[0] = True
    try:
        yield
    finally:
        _separate[0] = before


def _key(i: int, d) -> object:
    """The sharing key of slot ``i`` on device ``d``."""
    return i if _separate[0] else str(d)


def _devices(xs, devices):
    devs = [x.device for x in xs] if devices is None else list(devices)
    if len(devs) != len(xs):
        raise ValueError(f"{len(xs)} slot tensors but {len(devs)} devices")
    return devs


def _fan_out(result: torch.Tensor, devs) -> list:
    """``result`` on each slot's device, one copy per distinct device."""
    per_device: dict = {}
    out = []
    for i, d in enumerate(devs):
        key = _key(i, d)
        if key not in per_device:
            per_device[key] = (result.clone() if _separate[0]
                               else result.to(d))
        out.append(per_device[key])
    return out


def per_device(fn, devices, *cols) -> list:
    """``fn`` over the slots' arguments (``cols``: one list per argument,
    one entry per slot), called once per distinct device with its first
    slot's arguments; the device's other slots share the result. For
    arguments that are the same on every slot of a device: a replicated
    weight, a collective's result, the device itself."""
    per: dict = {}
    out = []
    for i, (d, args) in enumerate(zip(devices, zip(*cols))):
        key = _key(i, d)
        if key not in per:
            per[key] = fn(*args)
        out.append(per[key])
    return out


def distinct(xs) -> list:
    """The first slot of each distinct tensor object of a per-slot list
    (slots that share storage hold one object), in slot order."""
    if _separate[0]:
        return list(range(len(xs)))
    seen: set = set()
    out = []
    for s, x in enumerate(xs):
        if id(x) not in seen:
            seen.add(id(x))
            out.append(s)
    return out


def per_piece(fn, xs, keys=None) -> list:
    """``fn`` over a per-slot list of tensors, called once for each
    distinct tensor object (slots that share storage hold one), or with
    ``keys`` (one per slot) once for each distinct key; the slots share
    the result."""
    made: dict = {}
    out = []
    for i, x in enumerate(xs):
        key = i if _separate[0] else id(x) if keys is None else keys[i]
        if key not in made:
            made[key] = fn(x)
        out.append(made[key])
    return out


def over_groups(fn, xs, groups, devices, *args) -> list:
    """``fn(group's tensors, *args, devices=group's devices)`` (a
    collective) for each group of slots (lists of slot indices),
    scattered back to one result per slot. Groups that hold the same
    tensors on the same devices (storage shared on one card) share one
    call."""
    out = [None] * len(xs)
    done: dict = {}
    for grp in groups:
        ins = [xs[s] for s in grp]
        devs = [devices[s] for s in grp]
        key = (tuple(grp) if _separate[0]
               else tuple(map(id, ins)) + tuple(map(str, devs)))
        if key not in done:
            done[key] = fn(ins, *args, devices=devs)
        for s, o in zip(grp, done[key]):
            out[s] = o
    return out


def all_reduce(xs, devices=None, op: str = "sum") -> list:
    """Every slot gets the reduction of all slots' tensors (``op``:
    ``"sum"`` in slot order, or ``"max"``)."""
    devs = _devices(xs, devices)
    if len(xs) == 1:
        return [xs[0].to(devs[0])]
    if op not in ("sum", "max"):
        raise ValueError(f"all_reduce op must be 'sum' or 'max', got {op!r}")
    counter.add("all-reduce", xs)
    acc = xs[0].to(devs[0])
    for x in xs[1:]:
        x = x.to(devs[0])
        acc = acc + x if op == "sum" else torch.maximum(acc, x)
    return _fan_out(acc, devs)


def all_gather(xs, dim: int, devices=None) -> list:
    """Every slot gets all slots' tensors concatenated along ``dim``, in
    slot order."""
    devs = _devices(xs, devices)
    if len(xs) == 1:
        return [xs[0].to(devs[0])]
    counter.add("all-gather", xs)
    full = torch.cat([x.to(devs[0]) for x in xs], dim=dim)
    return _fan_out(full, devs)


def reduce_scatter(xs, dim: int, devices=None) -> list:
    """Slot ``i`` gets piece ``i`` (of ``len(xs)`` equal pieces along
    ``dim``) of the sum of all slots' tensors, summed in slot order on
    its own device."""
    devs = _devices(xs, devices)
    n = len(xs)
    if n == 1:
        return [xs[0].to(devs[0])]
    size = xs[0].shape[dim]
    if size % n:
        raise ValueError(f"reduce_scatter: dimension {dim} of size {size} "
                         f"does not divide into {n} pieces")
    counter.add("reduce-scatter", xs)
    step = size // n
    out = []
    for i, d in enumerate(devs):
        acc = xs[0].narrow(dim, i * step, step).to(d)
        for x in xs[1:]:
            acc = acc + x.narrow(dim, i * step, step).to(d)
        out.append(acc)
    return out


def all_to_all(xs, split_dim: int, cat_dim: int, devices=None) -> list:
    """Slot ``j`` gets piece ``j`` (along ``split_dim``) of every slot's
    tensor, concatenated along ``cat_dim`` in slot order."""
    devs = _devices(xs, devices)
    n = len(xs)
    if n == 1:
        return [xs[0].to(devs[0])]
    size = xs[0].shape[split_dim]
    if size % n:
        raise ValueError(f"all_to_all: dimension {split_dim} of size {size} "
                         f"does not divide into {n} pieces")
    counter.add("all-to-all", xs)
    step = size // n
    return [torch.cat([x.narrow(split_dim, j * step, step).to(d)
                       for x in xs], dim=cat_dim)
            for j, d in enumerate(devs)]


def all_to_all_heads(xs, devices=None) -> list:
    """Head-major pieces to contiguous ones. Slot ``p`` of ``n`` holds
    (..., H, c): columns ``p*c .. (p+1)*c`` of every head of a whole
    (..., H, n*c); slot ``q`` gets piece ``q`` of the whole flattened
    head-major to (..., H*n*c), cut into ``n`` equal contiguous pieces:
    (..., H*c). Piece ``q`` is the (head, slot) pairs ``s = head*n +
    slot`` for ``s`` in ``q*H .. (q+1)*H``, in order, whatever ``n`` and
    ``H`` (an mLSTM split over ``dv`` into the columns its ``norm_h`` and
    ``w_down`` rows hold)."""
    devs = _devices(xs, devices)
    n = len(xs)
    if n == 1:
        return [xs[0].flatten(-2).to(devs[0])]
    counter.add("all-to-all", xs)
    heads = xs[0].shape[-2]
    return [torch.cat([xs[s % n][..., s // n, :].to(d)
                       for s in range(q * heads, (q + 1) * heads)], dim=-1)
            for q, d in enumerate(devs)]
