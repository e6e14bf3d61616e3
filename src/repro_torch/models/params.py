"""Parameter specs: one source of truth for shapes, logical axes and init.

``Model.param_specs()`` (in transformer.py) returns a nested dict of
``Spec``; from it come
  * ``init_params``      — materialized tensors, the reference's init rules;
  * ``abstract_params``  — ``meta`` tensors, each with its ``Placement``
                           (a dry run's shapes and per-slot pieces);
  * ``place_params``     — a whole tree cut into per-slot pieces on a
                           mesh by the rules (``gather_params`` inverts it).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core.device import resolve_device
from ..sharding.placed import Sharded, shard, unshard
from ..sharding.rules import Rules, named_sharding

__all__ = ["Spec", "init_params", "abstract_params", "place_params",
           "gather_params", "param_placements", "spec_tree_bytes",
           "tree_map", "tree_leaves"]


@dataclasses.dataclass(frozen=True)
class Spec:
    shape: tuple
    axes: tuple              # logical axis names (len == ndim)
    init: str = "normal"     # 'normal' | 'zeros' | 'ones'
    scale: float | None = None  # None -> 1/sqrt(fan_in = shape[-2] or [-1])

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"Spec shape {self.shape} and axes {self.axes} "
                             "differ in length")


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of a nested dict (and the same leaves of
    ``rest``, trees of one structure), keys in sorted order (the order
    ``jax.tree`` flattens a dict in)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def init_params(specs, generator: torch.Generator, dtype=torch.bfloat16,
                device=None):
    """Materialize ``specs``: zeros, ones, or normal x ``scale`` (default
    1/sqrt(fan_in), fan_in = shape[-2], or shape[-1] for a vector), drawn
    in float32 from ``generator`` on its own device, leaf by leaf in
    sorted-key order, then cast to ``dtype`` on ``device`` (default: the
    first CUDA device). A generator on the CPU gives the same weights on
    every device; one on the card draws a full-size model in seconds."""
    dev = resolve_device(device)

    def make(s: Spec):
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=dtype, device=dev)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=dtype, device=dev)
        fan_in = s.shape[-2] if len(s.shape) >= 2 else max(s.shape[-1], 1)
        scale = s.scale if s.scale is not None else 1.0 / math.sqrt(fan_in)
        x = torch.randn(s.shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return x.mul_(scale).to(device=dev, dtype=dtype)
    return tree_map(make, specs)


def spec_tree_bytes(specs, bytes_per_el: int = 2) -> int:
    return sum(int(np.prod(s.shape)) * bytes_per_el
               for s in tree_leaves(specs))


def param_placements(specs, mesh, rules: Rules):
    """Each spec's ``Placement`` on ``mesh`` by ``rules`` (a logical axis
    that does not divide is replicated)."""
    return tree_map(lambda s: named_sharding(mesh, rules, s.axes, s.shape),
                    specs)


def abstract_params(specs, mesh, rules: Rules, dtype=torch.bfloat16,
                    strict: bool = False):
    """``meta`` tensors, each with its placement: a tree of ``Sharded``
    whose pieces are ``meta`` tensors of each slot's local shape. Nothing
    is allocated (the reference's ``ShapeDtypeStruct``s with their
    ``NamedSharding``s)."""
    def one(s: Spec):
        return shard(torch.empty(s.shape, dtype=dtype, device="meta"),
                     named_sharding(mesh, rules, s.axes, s.shape,
                                    strict=strict))
    return tree_map(one, specs)


def place_params(params, placements):
    """A whole param tree cut into per-slot pieces by ``placements``
    (``param_placements``' tree): a tree of ``Sharded``, each slot
    holding only its piece on its device."""
    return tree_map(lambda x, p: shard(x, p), params, placements)


def gather_params(placed, device=None):
    """``place_params`` inverted: the whole tensors, on ``device``
    (default: each leaf's first slot's). Leaves that are not ``Sharded``
    pass through."""
    return tree_map(lambda x: unshard(x, device) if isinstance(x, Sharded)
                    else x, placed)
