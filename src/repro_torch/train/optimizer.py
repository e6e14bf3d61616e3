"""AdamW (from scratch) with float32 master weights.

The port of the JAX package's ``train/optimizer.py`` on one device, as
plain functions on the port's parameter dicts (``models/params``, leaves
in sorted-key order, the order ``jax.tree`` flattens a dict in). Model
params live in bf16; the optimizer carries float32 master weights and
moments.

Every scalar of the update is a float32 tensor on the params' device, as
in the reference: the step is an int32 0-dim tensor, and ``cosine_lr``,
the bias corrections ``1 - b**step`` and the clip scale are computed in
float32 (at step 1 Adam's update is +-lr, so the last bit of lr shows in
every weight). Python scalars enter only where the reference has a
Python constant (``b1``, ``1 - b1``, ``eps``, ``weight_decay``), and
divisions always divide by a tensor: CUDA divides by a host scalar as a
product with its reciprocal, which rounds differently.

``zero1_shardings`` is the reference's ZeRO-1 placement: every
optimizer-state leaf spread over the ``data`` axis on top of its param's
placement (the data-parallel train step, ``trainer.make_train_step`` on
a mesh, holds and updates only each data slot's piece).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..models.params import tree_leaves, tree_map
from ..sharding.rules import Placement

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm",
           "cosine_lr", "step_scalars", "update_leaf", "zero1_shardings",
           "zero1_spec"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000


def _f32(value, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a float32 0-dim tensor on ``like``'s device (a Python
    float rounds to float32 as a JAX weak-typed constant does)."""
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def cosine_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay; ``step`` an int 0-dim tensor ->
    float32 0-dim tensor."""
    s = step.float()
    warm = torch.clamp(s / _f32(max(cfg.warmup_steps, 1), s), max=1.0)
    prog = torch.clamp(
        (step - cfg.warmup_steps).float()
        / _f32(max(cfg.total_steps - cfg.warmup_steps, 1), s), 0.0, 1.0)
    return (_f32(cfg.lr, s) * warm * 0.5
            * (1.0 + torch.cos(_f32(math.pi, s) * prog)))


def adamw_init(params) -> dict:
    """Fresh optimizer state: step 0 (int32), float32 master copies of
    ``params`` and zero moments, on the params' device."""
    dev = tree_leaves(params)[0].device
    return {
        "step": torch.zeros((), dtype=torch.int32, device=dev),
        "master": tree_map(lambda p: p.to(torch.float32, copy=True), params),
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params),
        "v": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params),
    }


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in the reference's leaf order) of each
    leaf's float32 sum of squares."""
    total = 0
    for x in tree_leaves(tree):
        total = total + x.float().square().sum()
    return torch.sqrt(total)


def update_leaf(cfg: AdamWConfig, g, m, v, w, scale, lr, b1c, b2c) -> None:
    """One leaf's AdamW step, written into ``m``, ``v`` and ``w`` (float32):
    the reference's ``upd`` operation by operation, so each intermediate
    rounds as there, with one leaf's temporaries alive at a time."""
    g = g.float() * scale
    m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
    v.mul_(cfg.b2).add_((1 - cfg.b2) * g.square_())
    del g
    upd = m / b1c
    upd.div_((v / b2c).sqrt_().add_(cfg.eps))
    upd.add_(cfg.weight_decay * w)
    w.sub_(upd.mul_(lr))


def step_scalars(cfg: AdamWConfig, step: torch.Tensor,
                 gnorm: torch.Tensor):
    """(step + 1, clip scale, lr, 1 - b1**step, 1 - b2**step) of an
    update from ``step`` at gradient norm ``gnorm``, each a 0-dim tensor
    (float32 but the step)."""
    step = step + 1
    scale = torch.clamp(_f32(cfg.clip_norm, gnorm)
                        / (gnorm + _f32(1e-9, gnorm)), max=1.0)
    lr = cosine_lr(cfg, step)
    sf = step.float()
    b1c = 1.0 - torch.pow(_f32(cfg.b1, sf), sf)
    b2c = 1.0 - torch.pow(_f32(cfg.b2, sf), sf)
    return step, scale, lr, b1c, b2c


def adamw_update(cfg: AdamWConfig, grads, opt_state,
                 param_dtype=torch.bfloat16, *, inplace: bool = False):
    """Returns (new_params, new_opt_state, {"grad_norm", "lr"}).

    ``param_dtype`` defaults to bf16, as in the reference, and its train
    step never passes it: a state initialised in float32 holds bf16 params
    after the first step (kept as the reference does it). New params are
    fresh tensors. ``inplace=True`` writes the new master weights and
    moments into ``opt_state``'s own tensors, one leaf at a time, instead
    of copies: the train step's choice, since a second copy of a
    full-size optimizer state does not fit beside it on the card."""
    gnorm = global_norm(grads)
    step, scale, lr, b1c, b2c = step_scalars(cfg, opt_state["step"], gnorm)

    def own(tree):
        return tree if inplace else tree_map(torch.clone, tree)
    new_m, new_v, new_w = (own(opt_state[k]) for k in ("m", "v", "master"))
    for g, m, v, w in zip(tree_leaves(grads), tree_leaves(new_m),
                          tree_leaves(new_v), tree_leaves(new_w)):
        update_leaf(cfg, g, m, v, w, scale, lr, b1c, b2c)
    new_params = tree_map(lambda w: w.to(param_dtype, copy=True), new_w)
    new_state = {"step": step, "master": new_w, "m": new_m, "v": new_v}
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}


# ---------------------------------------------------------------------- #
def zero1_spec(spec: tuple, shape: tuple, mesh) -> tuple:
    """The reference's widening of one param spec: itself when it is
    already split over ``data``; else ``data`` on the first dimension
    that is free and divides by it, or ``(entry, "data")`` on the first
    split dimension whose size divides by both, whichever comes first;
    else the param's own spec."""
    dsize = mesh.shape["data"]
    spec = list(spec) + [None] * (len(shape) - len(spec))
    for entry in spec:
        if entry == "data" or (isinstance(entry, tuple) and "data" in entry):
            return tuple(spec)
    for i, (dim, entry) in enumerate(zip(shape, spec)):
        if entry is None and dim % dsize == 0:
            spec[i] = "data"
            return tuple(spec)
        if entry is not None and not isinstance(entry, tuple):
            if dim % (mesh.shape[entry] * dsize) == 0:
                spec[i] = (entry, "data")
                return tuple(spec)
    return tuple(spec)


def zero1_shardings(param_placements, mesh, shapes=None):
    """Opt-state placements: each param's spec widened by ``zero1_spec``,
    for ``master``, ``m`` and ``v``, and a replicated ``step``; None on a
    mesh without a ``data`` axis. ``param_placements`` is a tree of
    ``Placement`` (``shapes``, a tree of shapes of the same structure,
    gives the params' sizes) or a tree of ``Sharded``/``abstract_params``
    leaves, which carry both."""
    if "data" not in mesh.shape:
        return None
    if shapes is None:
        shapes = tree_map(lambda x: tuple(x.shape), param_placements)
        param_placements = tree_map(lambda x: x.placement, param_placements)

    def widen(p: Placement, shape):
        return Placement(mesh, zero1_spec(p.spec, shape, mesh))
    structs = tree_map(widen, param_placements, shapes)
    return {"step": Placement(mesh, ()), "master": structs, "m": structs,
            "v": structs}
