"""The data-parallel ZeRO-1 train step over a mesh, and the loss over
vocab-split logits.

The port of what the reference's ``make_train_step`` does under a mesh
(``pjit`` over the rules' placements; XLA adds the collectives), written
out over the slots of ``launch/mesh.Mesh`` with ``sharding/collectives``:

  * the batch is cut over the ``(pod, data)`` groups, and each group runs
    its ``microbatches`` in turn through the model's tensor-parallel
    forward (``models/parallel``), accumulating float32 gradients of its
    slots' weight pieces (a weight replicated over the ``model`` slots
    gets the sum of their partial gradients: an ``all_reduce`` where the
    slots held distinct copies). An MoE model's groups run in lockstep
    instead (one routing spans the batch): microbatch k is rows
    k*B/mb .. (k+1)*B/mb of the whole batch, spread over the groups, as
    the reference cuts it, and each group's slots get their partials of
    that microbatch's one loss;
  * the gradients are ``reduce_scatter``ed over ``data`` onto the ZeRO-1
    pieces (``optimizer.zero1_shardings``) and divided by the count of
    losses summed: the mean, as the single-device step's over
    ``data x microbatches`` microbatches (for MoE, over ``microbatches``
    of the whole batch, the reference's), an ``all_reduce`` where no
    dimension divides, and over ``pod`` first;
  * the clip's global norm is an ``all_reduce`` of each slot's sum of
    squares over the pieces it owns;
  * AdamW updates each piece of ``master``, ``m`` and ``v`` once, on the
    slot that holds it, and the new bf16 params are ``all_gather``ed over
    ``data`` (an FSDP-split weight stays split).

Each group's loss and microbatch loop are the single-device step's
(``loss.py``: the loss over vocab-split logits needs no gather); what
is the mesh's own is the reduction of the groups' gradients and the
update of each slot's pieces.
"""
from __future__ import annotations

import torch

from ..models.parallel import Group, leafify
from ..models.params import place_params, tree_leaves, tree_map
from ..sharding import collectives as coll
from ..sharding.placed import Sharded, unshard
from .loss import batch_loss, grad_sums
from .optimizer import (AdamWConfig, step_scalars, update_leaf,
                        zero1_shardings)

__all__ = ["make_mesh_train_step",
           "train_state_placements", "place_train_state",
           "gather_train_state"]


# ---------------------------------------------------------------------- #
# placements of a train state
# ---------------------------------------------------------------------- #
def train_state_placements(model) -> dict:
    """The placements of a train state on the model's mesh: the params'
    by the rules, ``master``/``m``/``v`` by ZeRO-1 (the params' own on a
    mesh without ``data``), and ``step`` on the first slot's device."""
    mesh = model.mesh
    pp = model.plan.placements
    shapes = tree_map(lambda s: tuple(s.shape), model.param_specs())
    zero = zero1_shardings(pp, mesh, shapes) or {"master": pp, "m": pp,
                                                 "v": pp}
    return {"params": pp, "opt": {"step": mesh.devices[0],
                                  "master": zero["master"],
                                  "m": zero["m"], "v": zero["v"]}}


def _sub_piece(piece, pp, po, shape, slot):
    """The part of a slot's param piece (placement ``pp``) that is its
    optimizer piece (placement ``po``, a refinement of ``pp``)."""
    outer = pp.slices(shape, slot)
    inner = po.slices(shape, slot)
    return piece[tuple(slice(i.start - o.start, i.stop - o.start)
                       for i, o in zip(inner, outer))]


def place_train_state(model, state=None, params=None) -> dict:
    """A train state on the model's mesh: a whole ``state`` cut into
    pieces, or a fresh AdamW state built on already placed ``params``
    (float32 master pieces cut from each slot's param piece, zero
    moments), without a whole copy of the optimizer state."""
    pl = train_state_placements(model)
    mesh = model.mesh
    if state is not None:
        opt = state["opt"]
        return {"params": place_params(state["params"], pl["params"]),
                "opt": {"step": opt["step"].to(pl["opt"]["step"]),
                        **{k: place_params(opt[k], pl["opt"][k])
                           for k in ("master", "m", "v")}}}

    def master_of(x: Sharded, po):
        views = [_sub_piece(p, x.placement, po, x.shape, s)
                 for s, p in enumerate(x.shards)]
        keys = [(id(p), tuple((i.start, i.stop)
                              for i in po.slices(x.shape, s)))
                for s, p in enumerate(x.shards)]
        return Sharded(po, x.shape, tuple(coll.per_piece(
            lambda v: v.to(torch.float32, copy=True), views, keys)))

    def zeros_like(x: Sharded):
        return Sharded(x.placement, x.shape, tuple(coll.per_piece(
            torch.zeros_like, list(x.shards))))
    master = tree_map(master_of, params, pl["opt"]["master"])
    return {"params": params,
            "opt": {"step": torch.zeros((), dtype=torch.int32,
                                        device=mesh.devices[0]),
                    "master": master,
                    "m": tree_map(zeros_like, master),
                    "v": tree_map(zeros_like, master)}}


def gather_train_state(state, device=None) -> dict:
    """A placed train state as whole tensors on ``device``."""
    def whole(x):
        return unshard(x, device) if isinstance(x, Sharded) else (
            x if device is None else x.to(device))
    return tree_map(whole, state)


# ---------------------------------------------------------------------- #
# the data-parallel ZeRO-1 step
# ---------------------------------------------------------------------- #
def _zero_dim(po) -> int | None:
    for i, e in enumerate(po.spec):
        if e == "data" or (isinstance(e, tuple) and "data" in e):
            return i
    return None


def make_mesh_train_step(model, opt_cfg: AdamWConfig, microbatches: int = 1):
    """``step(state, batch) -> (new_state, metrics)`` of a placed train
    state (``place_train_state``) over the model's mesh; see the module
    docstring. ``metrics``: ``ce``, ``aux`` and ``loss`` (means over all
    microbatches), ``grad_norm`` and ``lr``."""
    plan, mesh = model.plan, model.mesh
    pl = train_state_placements(model)
    n_groups = len(plan.groups)
    lock = model.cfg.moe is not None and n_groups > 1
    data_groups = mesh.groups(("data",))
    pod_groups = mesh.groups(("pod",)) if "pod" in mesh.shape else None

    def group_grads(g, batch):
        """One group's float32 gradient sums over its microbatches of its
        rows -> (per-slot trees of them, losses, metrics)."""
        lt, leaves = leafify(g.trees)
        part = [Group(g.slots, lt, g.devs, slice(None))]
        rows = {k: v[g.rows].to(g.devs[0]) for k, v in batch.items()}
        grads, losses, mets = grad_sums(
            lambda one: batch_loss(model, part, one), leaves, rows,
            microbatches)
        by = {id(x): gr.float() for x, gr in zip(leaves, grads)}
        del grads
        return [tree_map(lambda x: by[id(x)], t) for t in lt], losses, mets

    def lockstep_grads(groups, batch):
        """An MoE model's groups in lockstep: microbatch k is rows
        k*B/mb .. (k+1)*B/mb of the whole batch, each group its share of
        them, through one loss (one routing) -> (per group, the per-slot
        trees of each group's float32 gradient sums, losses, metrics).
        Each group's weights are leaves of their own, so each gets its
        partial of the one loss's gradient."""
        lts, leaves = [], []
        for g in groups:
            lt, lv = leafify(g.trees)
            lts.append(lt)
            leaves += lv
        rows = plan.rows_of(batch["tokens"].shape[0] // microbatches)
        part = [Group(g.slots, lt, g.devs, r)
                for g, lt, r in zip(groups, lts, rows)]
        grads, losses, mets = grad_sums(
            lambda one: batch_loss(model, part, one), leaves, batch,
            microbatches)
        by = {id(x): gr.float() for x, gr in zip(leaves, grads)}
        del grads
        return ([[tree_map(lambda x: by[id(x)], t) for t in lt]
                 for lt in lts], losses, mets)

    def train_step(state, batch):
        params, opt = state["params"], state["opt"]
        b = batch["tokens"].shape[0]
        if b % (n_groups * (microbatches if lock else 1)):
            raise ValueError(f"a batch of {b} rows does not divide over "
                             f"{n_groups} data slots"
                             + (f" x {microbatches} microbatches" if lock
                                else ""))
        grads = [None] * mesh.size
        losses, mets = [], []
        groups = model.slot_groups(params, b)
        if lock:
            trees, losses, mets = lockstep_grads(groups, batch)
        else:
            trees = []
            for g in groups:
                t, lo, me = group_grads(g, batch)
                trees.append(t)
                losses += lo
                mets += me
        for g, t in zip(groups, trees):
            for s, x in zip(g.slots, t):
                grads[s] = x
        del trees
        grad_leaves = [tree_leaves(g) for g in grads]
        del grads
        p_leaves = tree_leaves(params)
        o_pl = tree_leaves(pl["opt"]["master"])
        div = torch.tensor(float(microbatches if lock else
                                 n_groups * microbatches),
                           dtype=torch.float32, device=mesh.devices[0])
        pieces = []          # per param leaf: per-slot gradient piece
        sq = [None] * mesh.size
        for i, (x, po) in enumerate(zip(p_leaves, o_pl)):
            per_slot = [grad_leaves[s][i] for s in range(mesh.size)]
            for s in range(mesh.size):
                grad_leaves[s][i] = None
            if "model" not in x.placement.axes():
                per_slot = _sum_model_partials(per_slot, plan.groups,
                                               mesh.devices)
            if pod_groups is not None:
                per_slot = coll.over_groups(coll.all_reduce, per_slot,
                                            pod_groups, mesh.devices)
            got = coll.per_piece(
                lambda g: g.div_(div.to(g.device)),
                _reduce_over_data(per_slot, _zero_dim(po), data_groups,
                                  mesh.devices))
            for s in range(mesh.size):
                if po.is_owner(s):
                    part = got[s].square().sum()
                    sq[s] = part if sq[s] is None else sq[s] + part
            pieces.append(got)
            del per_slot
        del grad_leaves
        zero = torch.zeros((), dtype=torch.float32, device=mesh.devices[0])
        total = coll.all_reduce([zero.to(mesh.devices[s]) if q is None else q
                                 for s, q in enumerate(sq)],
                                list(mesh.devices))[0]
        gnorm = torch.sqrt(total)
        step, scale, lr, b1c, b2c = step_scalars(opt_cfg, opt["step"], gnorm)
        on_dev: dict = {}

        def scalars(dev):
            key = str(dev)
            if key not in on_dev:
                on_dev[key] = tuple(t.to(dev) for t in (scale, lr, b1c,
                                                        b2c))
            return on_dev[key]
        new_leaves = []
        opt_leaves = zip(*(tree_leaves(opt[k]) for k in ("master", "m",
                                                          "v")))
        for i, (x, po, (w, m, v)) in enumerate(zip(p_leaves, o_pl,
                                                    opt_leaves)):
            for s in coll.distinct(w.shards):
                update_leaf(opt_cfg, pieces[i][s], m.shards[s], v.shards[s],
                            w.shards[s], *scalars(w.shards[s].device))
            pieces[i] = None
            new_leaves.append(_new_param(x, w, po))
        it = iter(new_leaves)
        new_params = tree_map(lambda _: next(it), params)
        dev0 = mesh.devices[0]

        def mean(xs):
            return torch.stack([x.float().to(dev0) for x in xs]).mean()
        metrics = {"ce": mean([m["ce"] for m in mets]),
                   "aux": mean([m["aux"] for m in mets]),
                   "loss": mean(losses), "grad_norm": gnorm, "lr": lr}
        new_opt = {"step": step, "master": opt["master"], "m": opt["m"],
                   "v": opt["v"]}
        return {"params": new_params, "opt": new_opt}, metrics

    def _new_param(x: Sharded, w: Sharded, po) -> Sharded:
        """The new bf16 param from its updated master pieces: cast, then
        ``all_gather``ed over ``data`` where ZeRO split what the param
        does not."""
        cast = coll.per_piece(lambda p: p.to(torch.bfloat16),
                              list(w.shards))
        zd = _zero_dim(po)
        if zd is not None and po.spec[zd] != x.placement.spec[zd]:
            cast = coll.over_groups(coll.all_gather, cast, data_groups,
                                    mesh.devices, zd)
        return Sharded(x.placement, x.shape, tuple(cast))

    return train_step


def _sum_model_partials(per_slot, groups, devices) -> list:
    """A weight replicated over ``model``: each model slot's gradient is
    its partial (the slot used its own copy), so every slot of a group
    gets the sum of the group's distinct gradient tensors. Slots that
    used one shared copy (one device) share one gradient, already the
    sum of their uses."""
    def reduce(xs, devices):
        firsts = coll.distinct(xs)
        if len(firsts) < 2:
            return xs
        red = coll.all_reduce([xs[i] for i in firsts],
                              [devices[i] for i in firsts])
        by = {id(xs[i]): r for i, r in zip(firsts, red)}
        return [by[id(x)] for x in xs]
    return coll.over_groups(reduce, per_slot, groups, devices)


def _reduce_over_data(per_slot, zd, groups, devices) -> list:
    """The data groups' gradients summed: ``reduce_scatter``ed along the
    ZeRO-1 dimension ``zd`` onto each slot's piece, ``all_reduce``d where
    no dimension splits (``zd`` None)."""
    if zd is None:
        return coll.over_groups(coll.all_reduce, per_slot, groups, devices)
    return coll.over_groups(coll.reduce_scatter, per_slot, groups, devices,
                            zd)
