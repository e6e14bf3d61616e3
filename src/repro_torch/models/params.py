"""Parameter specs: one source of truth for shapes, logical axes and init.

``Model.param_specs()`` (in transformer.py) returns a nested dict of
``Spec``; ``init_params`` materializes it as a nested dict of tensors
with the reference's init rules. The JAX package's ``abstract_params``
(sharded shape structs for its dry run) has no counterpart: the dry run
is not ported.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core.device import resolve_device

__all__ = ["Spec", "init_params", "spec_tree_bytes", "tree_map",
           "tree_leaves"]


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


def tree_map(fn, tree):
    """``fn`` over the leaves of a nested dict, keys in sorted order (the
    order ``jax.tree`` flattens a dict in)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


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
