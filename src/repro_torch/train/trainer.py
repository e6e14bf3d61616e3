"""The train and serve steps and the fault-tolerant training loop.

The port of the JAX package's ``train/trainer.py`` on one device.
``make_train_step(model, opt_cfg)`` returns ``step(state, batch)``:
forward (causal-LM cross entropy plus the MoE aux loss, ``loss.py``,
one form for one slot and for a mesh), gradients by
``torch.autograd.grad`` with respect to the param leaves (in the params'
dtype, as in the reference), clip, AdamW. Unlike the reference's pure
step, it updates the optimizer state's tensors in place (see
``adamw_update(inplace=True)``) and returns the new state dict.

The ``Trainer`` loop adds checkpoint/restart, deterministic-seek data
and a straggler watchdog, unchanged in behaviour. On a mesh (a model
built with ``mesh=``, or ``make_train_step(..., mesh=)``) the step is
the data-parallel ZeRO-1 step of ``train/parallel.py`` on a placed train
state: the same loss and microbatch loop (``loss.py``) per data group,
then the reductions over the mesh and AdamW on each slot's pieces.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch

from ..models.params import init_params, tree_leaves, tree_map
from .loss import grad_sums, make_loss_fn
from .optimizer import AdamWConfig, adamw_init, adamw_update
from .parallel import make_mesh_train_step, place_train_state

__all__ = ["make_loss_fn", "make_grad_fn", "make_train_step",
           "make_serve_step", "Trainer", "init_train_state",
           "abstract_train_state"]


def _unflatten(tree, leaves):
    """``leaves`` (in sorted-key order) in ``tree``'s structure."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def make_grad_fn(model, microbatches: int = 1) -> Callable:
    """``grad_fn(params, batch) -> (loss, metrics, grads)``: the loss and
    its ``ce`` and ``aux`` (0-dim float32 tensors, detached) and the
    gradient of every param leaf, in sorted-key order, by
    ``torch.autograd.grad``: in the params' dtype, as in the reference.

    ``microbatches > 1`` accumulates (``loss.grad_sums``): the float32
    sum of the microbatches' gradients is divided by mb, and loss and
    metrics are averaged."""
    loss_fn = make_loss_fn(model)

    def grad_fn(params, batch):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        tree = _unflatten(params, leaves)
        grads, losses, mets = grad_sums(lambda one: loss_fn(tree, one),
                                        leaves, batch, microbatches)
        if microbatches == 1:
            return losses[0], mets[0], grads
        div = torch.tensor(float(microbatches), dtype=torch.float32,
                           device=grads[0].device)
        metrics = {k: torch.stack([m[k] for m in mets]).mean()
                   for k in mets[0]}
        return (torch.stack(losses).mean(), metrics,
                [a.div_(div) for a in grads])

    return grad_fn


def make_train_step(model, opt_cfg: AdamWConfig, microbatches: int = 1,
                    mesh=None) -> Callable:
    """``step(state, batch) -> (new_state, metrics)`` with metrics ``ce``,
    ``aux``, ``loss``, ``grad_norm`` and ``lr`` (0-dim float32 tensors):
    ``make_grad_fn``'s gradients (accumulated over ``microbatches``),
    then AdamW with its clip.

    On a mesh (``mesh``, or the model's own) the step is data-parallel
    with ZeRO-1 (``train/parallel.make_mesh_train_step``): each data slot
    runs ``microbatches`` of its rows, so it equals the single-device
    step at ``data x microbatches`` microbatches (an MoE model's data
    slots run in lockstep over ``microbatches`` of the whole batch, so it
    equals the single-device step at ``microbatches``); the state is
    placed (``init_train_state`` of a model on the mesh)."""
    if mesh is not None and mesh is not model.mesh:
        model = type(model)(model.cfg, model.tp, mesh, model.rules)
    if model.plan is not None:
        return make_mesh_train_step(model, opt_cfg, microbatches)
    grad_fn = make_grad_fn(model, microbatches)

    def train_step(state, batch):
        params, opt = state["params"], state["opt"]
        loss, metrics, grads = grad_fn(params, batch)
        new_params, new_opt, opt_metrics = adamw_update(
            opt_cfg, _unflatten(params, grads), opt, inplace=True)
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step


def make_serve_step(model) -> Callable:
    """``serve_step(params, token, pos, cache) -> (next token (B, 1) int32,
    cache)``: one greedy decode step (the cache is written in place)."""
    def serve_step(params, token, pos, cache):
        logits, cache = model.decode_step(params, token, pos, cache)
        next_token = logits[:, -1].argmax(dim=-1).to(torch.int32)
        return next_token[:, None], cache
    return serve_step


# ---------------------------------------------------------------------- #
@dataclasses.dataclass
class Trainer:
    """Fault-tolerant loop: checkpoint/restart + straggler watchdog.

    The data source must be deterministic-seek (``batch_at(step)``): on
    restart the loop resumes at ``ckpt_step + 1`` with bit-identical data,
    so no sample is replayed or skipped. Step times are the host's clock
    around each call of ``step_fn``, as in the reference."""

    step_fn: Callable
    batch_at: Callable[[int], Any]
    checkpoint_manager: Any = None
    checkpoint_every: int = 50
    straggler_factor: float = 3.0
    on_straggler: Callable | None = None

    def run(self, state, start_step: int, num_steps: int,
            inject_failure_at: int | None = None):
        durations: list[float] = []
        metrics = {}
        step = start_step
        while step < start_step + num_steps:
            t0 = time.monotonic()
            if inject_failure_at is not None and step == inject_failure_at:
                inject_failure_at = None
                raise RuntimeError(f"injected node failure at step {step}")
            state, metrics = self.step_fn(state, self.batch_at(step))
            dt = time.monotonic() - t0
            durations.append(dt)
            med = sorted(durations)[len(durations) // 2]
            if (len(durations) >= 5 and dt > self.straggler_factor * med
                    and self.on_straggler is not None):
                self.on_straggler(step, dt, med)
            step += 1
            if self.checkpoint_manager and step % self.checkpoint_every == 0:
                self.checkpoint_manager.save(step, state)
        if self.checkpoint_manager:
            self.checkpoint_manager.save(step, state)
        return state, metrics, step


def init_train_state(model, generator: torch.Generator,
                     dtype=torch.bfloat16, device=None) -> dict:
    """``{"params", "opt"}``: ``init_params`` from ``generator`` in
    ``dtype`` on ``device`` (default: the first CUDA device), and a fresh
    AdamW state. For a model on a mesh the params are made on its first
    slot's device and placed, and the optimizer state is ZeRO-1's
    pieces."""
    if model.plan is not None:
        params = init_params(model.param_specs(), generator, dtype,
                             model.mesh.devices[0])
        return place_train_state(model, params=model.place(params))
    params = init_params(model.param_specs(), generator, dtype, device)
    return {"params": params, "opt": adamw_init(params)}


def abstract_train_state(model, dtype=torch.bfloat16) -> dict:
    """The train state's structure, shapes and dtypes as ``meta`` tensors
    (the counterpart of ``jax.eval_shape`` of ``init_train_state``): a
    restore target that allocates nothing."""
    def meta(shape, dt):
        return torch.empty(shape, dtype=dt, device="meta")
    params = tree_map(lambda s: meta(s.shape, dtype), model.param_specs())
    f32 = tree_map(lambda p: meta(p.shape, torch.float32), params)
    return {"params": params,
            "opt": {"step": meta((), torch.int32), "master": f32,
                    "m": f32, "v": f32}}

