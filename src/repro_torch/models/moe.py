"""Mixture-of-Experts: top-k router + capacity dispatch/combine, EP-ready.

The port of the JAX package's ``models/moe.py``. Dispatch avoids the
(tokens, experts, capacity) one-hot blow-up: each (token, choice) gets
its slot from a cumsum rank within its expert, tokens are scattered into
a dense (experts, capacity, d) buffer, the experts' SwiGLU runs as one
batched product over the expert axis (plain ``torch.matmul``, as the
reference leaves it to XLA, outside any kernel), and the results are
gathered back and weighted. Overflow choices are dropped (capacity-
factor semantics, decode included: at T = B tokens the capacity is often
1); a Switch-style aux loss keeps the router near-uniform.

Experts are padded to a multiple of ``tp`` (``pad_experts``): a padded
expert's router logit is -1e30, so it never routes, and the capacity is
``capacity_factor * T * k / E_padded``, as in the reference. Expert
parallelism (``moe_parts(experts=...)``): a ``model`` slot holds a range
of the experts (their router columns and weights); the routing is made
from every slot's logits, gathered, so it is the same on every slot;
each slot runs only its experts' buffer rows, and the slots' partial
outputs are summed by the caller's ``all_reduce``.

qwen2-moe's shared experts are one always-on dense SwiGLU of width
``d_ff_shared`` (= n_shared x per-expert width), as in the reference.
"""
from __future__ import annotations

import collections

import torch
import torch.nn.functional as F

from ..sharding.rules import pad_to_multiple
from .layers import swiglu
from .params import Spec

__all__ = ["moe_specs", "moe_block", "moe_parts", "pad_experts", "route",
           "dispatch", "plan_to", "Dispatch"]

NEG = -1e30


def pad_experts(n_experts: int, tp: int) -> int:
    """Experts padded to a multiple of ``tp``."""
    return n_experts if n_experts % tp == 0 else pad_to_multiple(n_experts,
                                                                 tp)


def moe_specs(layers: int, d_model: int, moe, tp: int) -> dict:
    e = pad_experts(moe.n_experts, tp)
    ff = moe.d_ff_expert
    sp = {
        "router": Spec((layers, d_model, e), ("layers", "embed", "experts")),
        "we_g": Spec((layers, e, d_model, ff),
                     ("layers", "experts", "embed_fsdp", "expert_mlp")),
        "we_u": Spec((layers, e, d_model, ff),
                     ("layers", "experts", "embed_fsdp", "expert_mlp")),
        "we_d": Spec((layers, e, ff, d_model),
                     ("layers", "experts", "expert_mlp", "embed_fsdp")),
    }
    if moe.d_ff_shared:
        sp["ws_g"] = Spec((layers, d_model, moe.d_ff_shared),
                          ("layers", "embed_fsdp", "mlp"))
        sp["ws_u"] = Spec((layers, d_model, moe.d_ff_shared),
                          ("layers", "embed_fsdp", "mlp"))
        sp["ws_d"] = Spec((layers, moe.d_ff_shared, d_model),
                          ("layers", "mlp", "embed_fsdp"))
    return sp


def route(router: torch.Tensor, xt: torch.Tensor, moe,
          n_experts_padded: int, logits: torch.Tensor | None = None):
    """Router of ``xt`` (T, d) -> (probs (T, E), top_w (T, k) renormalised,
    top_e (T, k)), all but ``top_e`` float32. ``logits`` (T, E), when
    given, replaces ``xt @ router`` (a mesh gathers them from the slots'
    expert columns).

    The logits are made in the weights' dtype and then cast to float32.
    Top-k ties: ``jax.lax.top_k`` returns the lower expert first among
    equal probabilities, which ``torch.topk`` does not promise; a stable
    descending sort does (bf16 logits make exact ties plausible)."""
    e = n_experts_padded
    logits = (xt @ router if logits is None else logits).float()
    if e != moe.n_experts:  # padded experts never route
        logits = torch.where(torch.arange(e, device=xt.device)
                             < moe.n_experts, logits, NEG)
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = vals[:, :moe.top_k], idx[:, :moe.top_k]
    return probs, top_w / top_w.sum(dim=-1, keepdim=True), top_e


# a routing's dispatch over T tokens: top-k weights and experts (T, k),
# each (token, choice)'s rank in its expert's queue and whether it is
# kept (T*k,), the capacity, and the aux loss
Dispatch = collections.namedtuple("Dispatch",
                                  "top_w top_e rank keep capacity aux")


def dispatch(routing, moe, n_experts_padded: int) -> Dispatch:
    """The dispatch of a ``route`` result over all its T tokens: the
    Switch-style aux loss, the capacity ``max(int(cf * T * k / E), 1)``,
    and the ranks in token-major order (a choice beyond the capacity is
    dropped)."""
    probs, top_w, top_e = routing
    e, k = n_experts_padded, moe.top_k
    tkns = top_e.shape[0]
    density = F.one_hot(top_e[:, 0], e).float().mean(dim=0)
    aux = (density * probs.mean(dim=0)).sum() * e * moe.aux_loss_weight
    capacity = max(int(moe.capacity_factor * tkns * k / e), 1)
    flat_e = top_e.reshape(-1)                               # (T*k,)
    rank = F.one_hot(flat_e, e).cumsum(dim=0).gather(
        1, flat_e[:, None])[:, 0] - 1
    return Dispatch(top_w, top_e, rank, rank < capacity, capacity, aux)


def plan_to(plan: Dispatch, device) -> Dispatch:
    """``plan``'s tensors on ``device``."""
    return Dispatch(*(x.to(device) if torch.is_tensor(x) else x
                      for x in plan))


def moe_block(p, x: torch.Tensor, moe, n_experts_padded: int):
    """x (B, L, d) -> (out (B, L, d), aux_loss float32 scalar)."""
    routed, shared, aux = moe_parts(p, x, moe, n_experts_padded)
    return (routed if shared is None else routed + shared), aux


def moe_parts(p, x: torch.Tensor, moe, n_experts_padded: int, *,
              experts: tuple | None = None, plan: Dispatch | None = None,
              first: int = 0):
    """x (B, L, d) -> (routed (B, L, d), shared (B, L, d) or None, aux
    float32 scalar), the parts ``moe_block`` adds.

    ``plan`` (``dispatch`` of a ``route`` result; default: x's own) may
    span more tokens than x's: x's are its tokens ``first ..``, and the
    capacity, ranks and aux loss are the plan's. ``experts=(first,
    count)``: ``p`` holds only those experts (their router columns are
    not used: ``plan`` must be given), and ``routed`` is their share of
    the output, zero for the choices of other experts."""
    b, l, d = x.shape
    tkns = b * l
    e, k = n_experts_padded, moe.top_k
    xt = x.reshape(tkns, d)
    if plan is None:
        plan = dispatch(route(p["router"], xt, moe, e), moe, e)
    e0, count = experts if experts is not None else (0, e)
    top_w = plan.top_w[first:first + tkns]
    flat_e = plan.top_e[first:first + tkns].reshape(-1)
    rank = plan.rank[first * k:(first + tkns) * k]
    keep = plan.keep[first * k:(first + tkns) * k]
    if experts is not None:   # this slot's experts only
        keep = keep & (flat_e >= e0) & (flat_e < e0 + count)

    # scatter into the expert buffer (E, C, d). Kept choices own distinct
    # slots; dropped ones all go to slot (0, 0) carrying zeros, so the
    # accumulating scatter is exact in any order of its atomics
    idx_e = torch.where(keep, flat_e - e0, 0)
    idx_c = torch.where(keep, rank, 0)
    src = torch.where(keep[:, None], xt.repeat_interleave(k, dim=0), 0)
    buf = torch.zeros((count, plan.capacity, d), dtype=x.dtype,
                      device=x.device)
    buf.index_put_((idx_e, idx_c), src, accumulate=True)

    # every expert's SwiGLU as one batched product over the expert axis
    out_buf = swiglu(buf, p["we_g"], p["we_u"], p["we_d"])   # (E, C, d)

    gathered = torch.where(keep[:, None], out_buf[idx_e, idx_c], 0)
    weights = top_w.reshape(-1)[:, None].to(x.dtype)
    routed = (gathered * weights).reshape(tkns, k, d).sum(dim=1).reshape(
        b, l, d)
    shared = None
    if "ws_g" in p:  # shared experts (always on)
        shared = swiglu(xt, p["ws_g"], p["ws_u"], p["ws_d"]).reshape(b, l, d)
    return routed, shared, plan.aux
