"""The train and serve steps and the fault-tolerant training loop.

The port of the JAX package's ``train/trainer.py`` on one device.
``make_train_step(model, opt_cfg)`` returns ``step(state, batch)``:
forward (causal-LM cross entropy plus the MoE aux loss), gradients by
``torch.autograd.grad`` with respect to the param leaves (in the params'
dtype, as in the reference), clip, AdamW. Unlike the reference's pure
step, it updates the optimizer state's tensors in place (see
``adamw_update(inplace=True)``) and returns the new state dict.

The ``Trainer`` loop adds checkpoint/restart, deterministic-seek data
and a straggler watchdog, unchanged in behaviour. A data-parallel step
over mesh slots (the reference's batch sharding, with its gradient
reduce) comes with ``sharding/``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch

from ..models.params import init_params, tree_leaves, tree_map
from .optimizer import AdamWConfig, adamw_init, adamw_update

__all__ = ["make_loss_fn", "make_grad_fn", "make_train_step",
           "make_serve_step", "Trainer", "init_train_state",
           "abstract_train_state"]


def make_loss_fn(model):
    """Causal-LM cross entropy: ``loss_fn(params, batch) -> (ce + aux,
    {"ce", "aux"})``, the reference's numbers: float32 logits, a detached
    row max, ``lse`` from the shifted exponentials, the frontend's prefix
    positions dropped, labels < 0 masked out. The label's logit comes
    from a gather where the reference sums a float32 one-hot product over
    the vocabulary: at tp = 1 that sum has one nonzero term, so the value
    is the same, without a (B, L, V) float32 one-hot (5 GB a microbatch
    at qwen2's 151 936 classes)."""
    def loss_fn(params, batch):
        logits, aux = model.forward(params, batch["tokens"],
                                    batch.get("extra_embeds"))
        labels = batch["labels"]
        # frontend prefix tokens carry no labels
        if logits.shape[1] != labels.shape[1]:
            logits = logits[:, logits.shape[1] - labels.shape[1]:]
        lf = logits.float()
        # no backward keeps the logits: drop them (and lf below) as soon
        # as they are read, 5 GB a microbatch at qwen2's vocabulary
        del logits
        m = lf.amax(dim=-1, keepdim=True).detach()
        lse = torch.log(torch.exp(lf - m).sum(dim=-1)) + m[..., 0]
        valid = labels >= 0
        label_logit = torch.where(
            valid, lf.gather(-1, torch.where(valid, labels, 0)[..., None]
                             .long())[..., 0], 0.0)
        del lf
        mask = valid.float()
        ce = -((label_logit - lse) * mask).sum() / torch.clamp(
            mask.sum(), min=1.0)
        return ce + aux.float(), {"ce": ce, "aux": aux}
    return loss_fn


def _unflatten(tree, leaves):
    """``leaves`` (in sorted-key order) in ``tree``'s structure."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def make_grad_fn(model, microbatches: int = 1) -> Callable:
    """``grad_fn(params, batch) -> (loss, metrics, grads)``: the loss and
    its ``ce`` and ``aux`` (0-dim float32 tensors, detached) and the
    gradient of every param leaf, in sorted-key order, by
    ``torch.autograd.grad``: in the params' dtype, as in the reference.

    ``microbatches > 1`` accumulates: microbatch k takes rows
    k*B/mb .. (k+1)*B/mb of every batch entry (the reference's reshape),
    the float32 sum of the gradients is divided by mb, and loss and
    metrics are averaged. Live activation memory shrinks by the
    microbatch factor."""
    loss_fn = make_loss_fn(model)

    def grads_of(params, batch):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        loss, metrics = loss_fn(_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                grads)

    def grad_fn(params, batch):
        if microbatches == 1:
            return grads_of(params, batch)
        rows = next(iter(batch.values())).shape[0]
        if rows % microbatches:
            raise ValueError(f"microbatches={microbatches} does not divide "
                             f"the batch of {rows} rows")
        per = rows // microbatches
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in tree_leaves(params)]
        losses, mets = [], []
        for k in range(microbatches):
            one = {key: x[k * per:(k + 1) * per] for key, x in batch.items()}
            loss, met, grads = grads_of(params, one)
            for a, g in zip(acc, grads):
                a.add_(g.float())
            del grads
            losses.append(loss)
            mets.append(met)
        div = torch.tensor(float(microbatches), dtype=torch.float32,
                           device=acc[0].device)
        metrics = {k: torch.stack([m[k] for m in mets]).mean()
                   for k in mets[0]}
        return (torch.stack(losses).mean(), metrics,
                [a.div_(div) for a in acc])

    return grad_fn


def make_train_step(model, opt_cfg: AdamWConfig,
                    microbatches: int = 1) -> Callable:
    """``step(state, batch) -> (new_state, metrics)`` with metrics ``ce``,
    ``aux``, ``loss``, ``grad_norm`` and ``lr`` (0-dim float32 tensors):
    ``make_grad_fn``'s gradients (accumulated over ``microbatches``),
    then AdamW with its clip."""
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
    AdamW state."""
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

