"""The causal-LM loss and its microbatched gradients, for every step.

``make_loss_fn(model)`` is the reference's cross entropy plus the MoE
aux loss over the model's slot groups (``Model.slot_groups``, an MoE
model's run together so that one routing spans the batch): off a mesh
one slot holding the whole logits, on a mesh the logits split over
the vocabulary per ``model`` slot, in the reference's own form, which
needs no gather: the row max is an ``all_reduce`` (max), the sum of the
exponentials an ``all_reduce``, and the label's logit comes from the
slot whose piece holds it, then an ``all_reduce``. Across groups the
sums of the masked log-likelihoods and the label counts are
``all_reduce``d, so the loss is the whole batch's mean. On one slot
every collective is the identity.

The numbers are the reference's: float32 logits, a detached row max,
``lse`` from the shifted exponentials, the frontend's prefix positions
dropped, labels < 0 masked out. The label's logit comes from a gather
where the reference sums a float32 one-hot product over the vocabulary:
at tp = 1 that sum has one nonzero term, so the value is the same,
without a (B, L, V) float32 one-hot (5 GB a microbatch at qwen2's
151 936 classes).

``grad_sums`` runs a loss over a batch's microbatches and sums the
gradients: the single-device step's, and each data group's in the mesh
step (``train/parallel.py``).
"""
from __future__ import annotations

import torch

from ..models.parallel import group_mean, lockstep
from ..sharding import collectives as coll

__all__ = ["make_loss_fn", "batch_loss", "ce_parts", "grad_sums"]


def ce_parts(model, logits: list, devs, labels):
    """One group's cross-entropy parts from its per-slot logits -> (sum of
    the masked log-likelihoods, label count), float32 0-dim tensors on
    the group's first device. ``logits`` is consumed (emptied): no bf16
    copy outlives its float32 one, 5 GB a microbatch at qwen2's
    vocabulary."""
    n = labels.shape[1]
    lfs = []
    while logits:
        lg = logits.pop(0)
        if lg.shape[1] != n:   # frontend prefix tokens carry no labels
            lg = lg[:, lg.shape[1] - n:]
        lfs.append(lg.float())
        del lg
    m = coll.all_reduce([lf.amax(dim=-1, keepdim=True).detach()
                         for lf in lfs], devs, op="max")
    se = coll.all_reduce([torch.exp(lf - mm).sum(dim=-1)
                          for lf, mm in zip(lfs, m)], devs)
    lse = torch.log(se[0]) + m[0][..., 0]
    parts = []
    for lf, dev, (v0, vl) in zip(lfs, devs, model.layout.vocab):
        lab = labels.to(dev)
        loc = lab - v0
        ok = (lab >= 0) & (loc >= 0) & (loc < vl)
        g = lf.gather(-1, torch.where(ok, loc, 0)[..., None].long())[..., 0]
        parts.append(torch.where(ok, g, 0.0))
    del lfs
    label_logit = coll.all_reduce(parts, devs)[0]
    mask = (labels.to(devs[0]) >= 0).float()
    return ((label_logit - lse) * mask).sum(), mask.sum()


def batch_loss(model, groups, batch):
    """``batch``'s loss over ``groups`` (``Model.slot_groups``' entries,
    each running its rows; an MoE model's together,
    ``models.parallel.lockstep``) ->
    (ce + aux, {"ce", "aux"}) on the first group's first device: the ce
    the whole batch's mean, the aux the mean of the runs'."""
    nums, cnts, auxs, devs = [], [], [], []
    for run in lockstep(model.cfg, groups):
        logits, aux = model.run_groups(run, batch["tokens"],
                                       batch.get("extra_embeds"))
        for g, lg in zip(run, logits):
            num, cnt = ce_parts(model, lg, g.devs, batch["labels"][g.rows])
            nums.append(num)
            cnts.append(cnt)
            devs.append(g.devs[0])
        auxs.append(aux)
    num = coll.all_reduce(nums, devs)[0]
    cnt = coll.all_reduce(cnts, devs)[0]
    ce = -num / torch.clamp(cnt, min=1.0)
    aux = group_mean(auxs)
    return ce + aux.float(), {"ce": ce, "aux": aux}


def make_loss_fn(model):
    """Causal-LM cross entropy: ``loss_fn(params, batch) -> (ce + aux,
    {"ce", "aux"})`` (see the module docstring); ``params`` whole off a
    mesh, placed on one."""
    def loss_fn(params, batch):
        groups = model.slot_groups(params, batch["tokens"].shape[0])
        return batch_loss(model, groups, batch)
    return loss_fn


def grad_sums(loss_of, leaves, batch, microbatches: int = 1):
    """``loss_of(microbatch) -> (loss, metrics)`` over ``batch`` cut into
    ``microbatches`` (microbatch k takes rows k*B/mb .. (k+1)*B/mb of
    every entry, the reference's reshape), differentiated by
    ``torch.autograd.grad`` with respect to ``leaves`` -> (gradients: at
    one microbatch as autograd gives them, in the leaves' dtype, as in
    the reference; else their float32 sum; each microbatch's loss; each
    one's metrics), all detached. A leaf no loss reaches gets zeros.
    Live activation memory shrinks by the microbatch factor."""
    rows = next(iter(batch.values())).shape[0]
    if rows % microbatches:
        raise ValueError(f"microbatches={microbatches} does not divide "
                         f"the batch of {rows} rows")
    per = rows // microbatches
    acc, losses, mets = None, [], []
    for k in range(microbatches):
        one = {key: x[k * per:(k + 1) * per] for key, x in batch.items()}
        loss, met = loss_of(one)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        if microbatches == 1:
            acc = grads
        elif acc is None:
            acc = [g.float() for g in grads]
        else:
            for a, g in zip(acc, grads):
                a.add_(g.float())
        del grads
        losses.append(loss.detach())
        mets.append({key: v.detach() for key, v in met.items()})
    return acc, losses, mets
