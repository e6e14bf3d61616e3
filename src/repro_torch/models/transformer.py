"""Model assembly: param specs, forward, prefill, decode step.

The port of the JAX package's ``models/transformer.py`` on one device,
for every family: dense and MoE transformers (every layer ``"attn"``,
with a SwiGLU MLP or a mixture of experts), the vision and audio
backbones (their frontends are stubs, ``models/frontend.py``), and the
pattern archs whose layers cycle through ``"rec"`` (RG-LRU, hybrid),
``"mlstm"`` and ``"slstm"`` (xLSTM).

``build(cfg, tp)`` pads as the reference's does: query heads and experts
to a multiple of ``tp``, the vocabulary too (padded logit columns are
the dtype's most negative value), the decode cache repeated to
``n_kv_cache`` heads (``attention.make_dims``). On one device such a
build runs the padded model whole; ``build(cfg, tp, mesh=)`` runs it
over a ``(pod, data, model)`` mesh (``models/parallel.py``: Megatron
tensor parallelism, expert parallelism and data parallelism), taking
params placed by ``Model.place``. Both run one body, ``run_groups``:
the layers over groups of ``model`` slots, each slot on its weights'
pieces with the collectives between them, the groups in lockstep (an
MoE model's: one routing over the batch) or one by one; off a mesh
there is one group of one slot holding the whole model, and every
collective is the identity.

Parameters are a plain nested dict of tensors, not parameters registered
on the module, so that one set of weights serves several builds (the
``"flash"`` and ``"jnp"`` attention paths) and maps one to one onto the
reference's tree: ``params["blocks"][kind]`` holds every layer of one
kind, stacked on a leading layer axis (``blocks.attn.attn.wq`` is the
reference's), and layer ``i`` of the stack is the ``i``-th layer of that
kind in ``cfg.layer_kinds()`` (the reference's per-kind counters).
``Model.layers`` is the one place that slices it, once per call (under
autograd one backward then stacks the layers' gradients, where a slice
per layer would each write a zero tensor the size of the whole stack); a
Python loop over the layers replaces the reference's ``lax.scan``, and
every decode state is written in place (the KV caches, and the recurrent
states of the other kinds, float32 as in the reference).

``forward`` (the training path) rematerialises each layer as the
reference's ``_maybe_remat`` does, by ``cfg.remat``: ``"none"``;
``"full"`` keeps only each layer's inputs; ``"dots"`` also keeps the
layer's unbatched matrix products (the weight products) and recomputes
the rest in the backward pass, the batched attention products included
(``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``). Remat
changes what the backward keeps, not the numbers, and acts only while
grad mode is on.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..configs.base import ModelConfig
from ..core.device import resolve_device
from ..launch.mesh import check_mesh
from ..sharding import collectives as coll
from ..sharding.rules import Rules, pad_to_multiple
from . import attention as attn
from . import moe as moe_mod
from . import rglru as rg
from . import ssm
from .layers import embed_tokens, mlp_specs, rms_norm, swiglu, unembed
from .parallel import Group, MeshPlan, SlotLayout, group_mean, lockstep
from .params import Spec, place_params, tree_leaves, tree_map

__all__ = ["Model", "build", "REMAT_MODES"]

REMAT_MODES = ("none", "dots", "full")
_aten = torch.ops.aten


def _dots_policy(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``"dots"``: save the matrix products
    with no batch dimension, recompute everything else. ``x @ w`` runs as
    ``mm``/``addmm``; an einsum against a weight (``bld,dhk->blhk``) as a
    ``bmm`` over a batch of one; attention's scores and the experts'
    products are ``bmm``s over real batches."""
    if op in (_aten.mm.default, _aten.addmm.default) or (
            op is _aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_contexts():
    return create_selective_checkpoint_contexts(_dots_policy)


class Model(torch.nn.Module):
    """A model of ``cfg``; holds no weights (see the module docstring).
    ``cfg.attn_impl`` picks the prefill attention: ``"flash"`` (kernel
    K7) or ``"jnp"`` (row-chunked plain PyTorch). With ``mesh`` (whose
    ``model`` axis must be ``tp`` slots) it runs over the mesh's slots,
    on params from ``place``; ``rules`` default to
    ``Rules.default(fsdp=cfg.fsdp)``."""

    def __init__(self, cfg: ModelConfig, tp: int = 1, mesh=None,
                 rules: Rules | None = None):
        super().__init__()
        if cfg.attn_impl not in ("flash", "jnp"):
            raise ValueError(f"attn_impl must be 'flash' or 'jnp', got "
                             f"{cfg.attn_impl!r}")
        if cfg.remat not in REMAT_MODES:
            raise ValueError(f"remat must be one of {REMAT_MODES}, got "
                             f"{cfg.remat!r}")
        if tp < 1:
            raise ValueError(f"tp must be >= 1, got {tp}")
        self.cfg = cfg
        self.tp = tp
        self.dims = attn.make_dims(cfg, tp)
        if "attn" in cfg.layer_kinds():
            attn.check_grouping(self.dims, tp)
        self.vocab_p = (cfg.vocab_size if cfg.vocab_size % tp == 0
                        else pad_to_multiple(cfg.vocab_size, tp))
        self.n_experts_p = (moe_mod.pad_experts(cfg.moe.n_experts, tp)
                            if cfg.moe else 0)
        self.rules = rules or Rules.default(fsdp=cfg.fsdp)
        self.mesh = None if mesh is None else check_mesh(mesh)
        self.plan = None if mesh is None else MeshPlan(self)
        self.layout = (SlotLayout.whole(self) if self.plan is None
                       else self.plan.layout)

    # ---------------------------------------------------------------- #
    # placement on a mesh
    # ---------------------------------------------------------------- #
    def place(self, params):
        """A whole param tree cut into the pieces each slot of the
        model's mesh holds (a tree of ``sharding.Sharded``)."""
        return place_params(params, self.plan.placements)

    # ---------------------------------------------------------------- #
    # parameter specs
    # ---------------------------------------------------------------- #
    def param_specs(self) -> dict:
        cfg, d = self.cfg, self.cfg.d_model
        specs: dict = {
            "embed": Spec((self.vocab_p, d), ("vocab", "embed")),
            "out_norm": Spec((d,), ("embed",), init="ones"),
        }
        if not cfg.tie_embeddings:
            specs["lm_head"] = Spec((d, self.vocab_p), ("embed_fsdp", "vocab"))
        kinds = cfg.layer_kinds()
        specs["blocks"] = {kind: self._block_specs(kind, kinds.count(kind))
                           for kind in dict.fromkeys(kinds)}
        if cfg.frontend == "vision":
            # anyres projector stub: projects the precomputed patch embeds
            specs["mm_proj"] = Spec((d, d), ("embed", "embed_fsdp"))
        return specs

    def _block_specs(self, kind: str, n: int) -> dict:
        cfg, d = self.cfg, self.cfg.d_model
        if kind == "attn":
            sp = {
                "ln1": Spec((n, d), ("layers", "embed"), init="ones"),
                "attn": attn.attn_specs(n, d, self.dims, cfg.qkv_bias),
                "ln2": Spec((n, d), ("layers", "embed"), init="ones"),
            }
            if cfg.moe is not None:
                sp["moe"] = moe_mod.moe_specs(n, d, cfg.moe, self.tp)
            elif cfg.d_ff:
                sp["mlp"] = mlp_specs(n, d, cfg.d_ff)
            return sp
        if kind == "rec":  # RG-LRU temporal mix + MLP
            return {
                "rec": rg.rglru_specs(n, d, cfg.rg_lru_dim or d,
                                      cfg.conv1d_width),
                "ln2": Spec((n, d), ("layers", "embed"), init="ones"),
                "mlp": mlp_specs(n, d, cfg.d_ff),
            }
        if kind == "mlstm":
            return {"cell": ssm.mlstm_specs(n, d, cfg.n_heads)}
        if kind == "slstm":
            return {"cell": ssm.slstm_specs(n, d, cfg.n_heads)}
        raise ValueError(kind)

    @staticmethod
    def layers(params: dict, kind: str = "attn") -> list:
        """Every layer of ``kind``'s weights, in order: each leaf of
        ``params["blocks"][kind]`` unbound once on its leading (layer)
        axis, so every layer's leaves are views."""
        stack = params["blocks"][kind]
        views = tree_map(lambda a: a.unbind(0), stack)
        n = len(tree_leaves(views)[0])
        return [tree_map(lambda v, i=i: v[i], views) for i in range(n)]

    @classmethod
    def layer(cls, params: dict, i: int, kind: str = "attn") -> dict:
        """The ``i``-th layer of ``kind``'s weights (``layers``' entry i;
        a loop over the layers takes ``layers`` once instead)."""
        return cls.layers(params, kind)[i]

    def _layers(self):
        """(kind, index within the kind) for every layer, in order."""
        seen: dict = {}
        for kind in self.cfg.layer_kinds():
            seen[kind] = seen.get(kind, 0) + 1
            yield kind, seen[kind] - 1

    def _head(self, params):
        return params["lm_head"] if "lm_head" in params else params["embed"].T

    # ---------------------------------------------------------------- #
    # the layers over one group's model slots (see models/parallel.py);
    # off a mesh the group is one slot holding the whole model
    # ---------------------------------------------------------------- #
    def _norm(self, h, ws, devs):
        eps = self.cfg.norm_eps
        return coll.per_device(lambda x, w: rms_norm(x, w, eps), devs, h, ws)

    def _split_norm(self, hs, ws, devs, split: bool):
        """RMS norm of an activation split over the slots' columns: the
        sum of squares ``all_reduce``d over them; each slot's columns
        normed by its piece of the weight. Whole on every slot when not
        ``split``."""
        eps = self.cfg.norm_eps
        if not split:
            return [rms_norm(x, w, eps) for x, w in zip(hs, ws)]
        xfs = [x.float() for x in hs]
        tot = coll.all_reduce([xf.square().sum(dim=-1, keepdim=True)
                               for xf in xfs], devs)
        n = sum(x.shape[-1] for x in hs)
        return [(xf * torch.rsqrt(t / n + eps)).to(x.dtype) * w
                for xf, t, x, w in zip(xfs, tot, hs, ws)]

    def _attend(self, p, hn, positions, dims, kv_select):
        cfg = self.cfg
        if cfg.attn_impl == "flash":
            return attn.flash_attention_block(p["attn"], hn, positions, dims,
                                              cfg.rope_theta, kv_select)
        return attn.attention(p["attn"], hn, positions, dims, cfg.rope_theta,
                              chunk=cfg.attn_chunk, unroll=cfg.unroll_attn,
                              kv_select=kv_select)

    def _attn_mix(self, ps, h, positions, devs, caches=None, i=None,
                  pos=None):
        """The attention half of an attention layer over one group's
        slots -> h per slot. Each slot runs its own query heads; their
        partial out-projections are ``all_reduce``d where the heads are
        split. ``caches`` (each slot's k, v stacks) with ``pos`` is a
        decode step against layer ``i``'s; ``caches`` alone a prefill
        that fills them; neither the full-sequence forward."""
        cfg, lay = self.cfg, self.layout
        hn = self._norm(h, [p["ln1"] for p in ps], devs)
        outs = []
        for m, p in enumerate(ps):
            dims, sel = lay.attn[m]
            if pos is not None:
                o, _, _ = attn.decode_attention(
                    p["attn"], hn[m], caches[m]["k"][i], caches[m]["v"][i],
                    pos, dims, cfg.rope_theta, sel)
            else:
                if caches is not None:
                    attn.prefill_kv_into_cache(
                        p["attn"], hn[m], positions[m], dims, cfg.rope_theta,
                        caches[m]["k"][i], caches[m]["v"][i], sel)
                o = self._attend(p, hn[m], positions[m], dims, sel)
            outs.append(o)
        if lay.heads_split:
            outs = coll.all_reduce(outs, devs)
        return coll.per_device(torch.add, devs, h, outs)

    def _mlp(self, ps, hn, devs):
        """The SwiGLU MLP on each slot: column/row-split and
        ``all_reduce``d, or whole."""
        def one(x, p):
            return swiglu(x, p["mlp"]["wg"], p["mlp"]["wu"], p["mlp"]["wd"])
        if self.layout.mlp_split:
            return coll.all_reduce([one(x, p) for x, p in zip(hn, ps)], devs)
        return coll.per_device(one, devs, hn, ps)

    def _ffn(self, ps, h, groups):
        """The second half of an attention layer over the groups (lists
        per group of per-slot values) -> (h per group, aux loss or None):
        the experts (one routing over every group's rows) and their aux
        loss, the MLP, or nothing."""
        cfg = self.cfg
        if cfg.moe is None and not cfg.d_ff:
            return h, None
        hn = [self._norm(hg, [p["ln2"] for p in pg], g.devs)
              for pg, hg, g in zip(ps, h, groups)]
        aux = None
        if cfg.moe is not None:
            out, aux = self._experts(ps, hn, groups)
        else:
            out = [self._mlp(pg, x, g.devs)
                   for pg, x, g in zip(ps, hn, groups)]
        return [coll.per_device(torch.add, g.devs, hg, og)
                for g, hg, og in zip(groups, h, out)], aux

    def _group_logits(self, logits, groups):
        """Each group's per-slot router logits (T_g, E) ``all_gather``ed
        over ``(pod, data)``, along the tokens in group order."""
        per_slot = [None] * self.mesh.size
        for g, lg in zip(groups, logits):
            for s, x in zip(g.slots, lg):
                per_slot[s] = x
        got = coll.over_groups(coll.all_gather, per_slot,
                               self.mesh.groups(("pod", "data")),
                               self.mesh.devices, 0)
        return [[got[s] for s in g.slots] for g in groups]

    def _experts(self, ps, hn, groups):
        """The experts over the groups' slots (expert parallelism where
        they are split) -> (out per group per slot, aux): one routing of
        all the experts over every group's tokens, in group order, made
        from the router logits (``all_gather``ed from the slots' columns,
        then over the groups), each slot's experts' share of its group's
        tokens, ``all_reduce``d over the group's slots."""
        moe, e, lay = self.cfg.moe, self.n_experts_p, self.layout
        xts = [[x.reshape(-1, x.shape[-1]) for x in hg] for hg in hn]
        logits = []
        for pg, xg, g in zip(ps, xts, groups):
            lg = [x @ p["moe"]["router"] for x, p in zip(xg, pg)]
            if lay.experts_split:
                lg = coll.all_gather(lg, 1, g.devs)
            logits.append(lg)
        if len(groups) > 1:
            logits = self._group_logits(logits, groups)
        plan = moe_mod.dispatch(moe_mod.route(
            ps[0][0]["moe"]["router"], xts[0][0], moe, e,
            logits=logits[0][0]), moe, e)
        out, first = [], 0
        for pg, hg, xg, g in zip(ps, hn, xts, groups):
            plans = coll.per_device(lambda d: moe_mod.plan_to(plan, d),
                                    g.devs, g.devs)
            routed, shared = [], []
            for m, p in enumerate(pg):
                r, sh, _ = moe_mod.moe_parts(p["moe"], hg[m], moe, e,
                                             experts=lay.experts[m],
                                             plan=plans[m], first=first)
                if sh is not None and lay.shared_split:
                    r = r + sh
                elif sh is not None:
                    shared.append(sh)
                routed.append(r)
            if lay.experts_split:
                routed = coll.all_reduce(routed, g.devs)
            if shared:
                routed = [r + s for r, s in zip(routed, shared)]
            out.append(routed)
            first += xg[0].shape[0]
        return out, plan.aux

    def _rec(self, ps, h, devs, sts):
        """RG-LRU over the slots' channels (``models/parallel.py``) ->
        (h, each slot's new state)."""
        split = self.layout.rec_split
        xn = self._norm(h, [p["rec"]["norm_in"] for p in ps], devs)
        gates, xcs, hists, ras, ris = map(list, zip(*(
            rg.rglru_in(p["rec"], x, st) for p, x, st in zip(ps, xn, sts))))
        if split:
            ras = coll.reduce_scatter(ras, -1, devs)
            ris = coll.reduce_scatter(ris, -1, devs)
        outs, hs = map(list, zip(*(
            rg.rglru_mix(p["rec"], x, *a) for p, x, a in
            zip(ps, h, zip(gates, xcs, ras, ris, sts)))))
        if split:
            outs = coll.all_reduce(outs, devs)
        return (coll.per_device(torch.add, devs, h, outs),
                [{"h": a, "conv": b.float()} for a, b in zip(hs, hists)])

    def _mlstm(self, ps, h, devs, sts):
        """The mLSTM over the slots (``models/parallel.py``): q, k and the
        gates reduced whole, v onto each slot's piece of ``dv``, the cell
        on it, its output turned to contiguous columns -> (h, each slot's
        new state: ``C`` on ``dv``, ``n`` on ``dk``)."""
        cfg, lay = self.cfg, self.layout
        heads, m = cfg.n_heads, len(ps)
        xn = self._norm(h, [p["cell"]["norm_in"] for p in ps], devs)
        _, qs, ks, vs, gifs = map(list, zip(*(
            ssm.mlstm_proj(p["cell"], x) for p, x in zip(ps, xn))))
        b, l = xn[0].shape[:2]
        du = ssm.UP * cfg.d_model
        hd = du // heads
        vs = [v.reshape(b, l, heads, hd) for v in vs]
        if lay.mlstm_split:
            qs, ks, gifs = (coll.all_reduce(t, devs) for t in (qs, ks, gifs))
            vs = (coll.reduce_scatter(vs, 3, devs) if lay.mlstm_cell_split
                  else coll.all_reduce(vs, devs))
        dv = vs[0].shape[-1]
        if sts[0] is None:
            cells = [ssm.init_mlstm_state(b, heads, hd, dv, device=d)
                     for d in devs]
        else:
            ns = [st["n"] for st in sts]
            if lay.mlstm_cell_split:
                ns = coll.all_gather(ns, -1, devs)
            cells = [{"C": st["C"], "n": n, "m": st["m"]}
                     for st, n in zip(sts, ns)]
        outs, new = [], []
        for k, (p, q, kk, v, g, c) in enumerate(zip(ps, qs, ks, vs, gifs,
                                                    cells)):
            g = g + p["cell"]["b_if"]
            y, c = ssm.mlstm_run(q.reshape(b, l, heads, hd),
                                 kk.reshape(b, l, heads, hd), v,
                                 g[..., :heads], g[..., heads:], c,
                                 cfg.mlstm_chunk)
            if lay.mlstm_cell_split:
                c = dict(c, n=c["n"].narrow(-1, k * dv, dv))
            new.append(c)
            outs.append(y)
        if lay.mlstm_cell_split:
            ys = coll.all_to_all_heads(outs, devs)
        elif lay.mlstm_split:
            ys = [y.reshape(b, l, du).narrow(-1, k * du // m, du // m)
                  for k, y in enumerate(outs)]
        else:
            ys = [y.reshape(b, l, du) for y in outs]
        ys = self._split_norm([y.to(h[0].dtype) for y in ys],
                              [p["cell"]["norm_h"] for p in ps], devs,
                              lay.mlstm_split)
        outs = [ssm.mlstm_out(p["cell"], x, y) for p, x, y in zip(ps, xn, ys)]
        if lay.mlstm_split:
            outs = coll.all_reduce(outs, devs)
        return coll.per_device(torch.add, devs, h, outs), new

    def _slstm(self, ps, h, devs, sts):
        """The sLSTM over the slots (``models/parallel.py``): the gate
        pre-activations ``all_gather``ed once, the token scan whole on
        each device -> (h, each slot's piece of the new state)."""
        cfg, lay = self.cfg, self.layout
        d, eps = cfg.d_model, cfg.norm_eps
        xn = self._norm(h, [p["cell"]["norm_in"] for p in ps], devs)
        gx = [x @ p["cell"]["w_gates"] + p["cell"]["b_gates"]
              for x, p in zip(xn, ps)]
        if lay.slstm_split:
            gx = coll.all_gather(gx, -1, devs)
        keys = ("c", "n", "h", "m")
        if sts[0] is None:
            st0 = coll.per_device(lambda dv: ssm.init_slstm_state(
                xn[0].shape[0], d, device=dv), devs, devs)
        elif lay.slstm_state_split:
            st0 = [dict(zip(keys, x.unbind(0))) for x in coll.all_gather(
                [torch.stack([st[k] for k in keys]) for st in sts], -1, devs)]
        else:
            st0 = sts
        ran = coll.per_device(lambda p, g, st: ssm.slstm_scan(
            p["cell"], cfg.n_heads, g, st), devs, ps, gx, st0)

        def out(p, x, r):
            y = rms_norm(r[1].to(x.dtype), p["cell"]["norm_h"], eps)
            return x + y @ p["cell"]["w_out"]
        if lay.slstm_state_split:
            dl = d // len(ps)
            new = [{k: v.narrow(-1, j * dl, dl) for k, v in r[0].items()}
                   for j, r in enumerate(ran)]
        else:
            new = [r[0] for r in ran]
        return coll.per_device(out, devs, ps, h, ran), new

    def _state_block(self, kind, ps, h, devs, stacks=None, i=None):
        """One layer of a recurrent kind over one group's slots -> h per
        slot: from layer ``i``'s state in ``stacks`` (each slot's,
        written back in place), else from fresh zeros."""
        sts = ([None] * len(ps) if stacks is None else
               [tree_map(lambda a: a[i], st) for st in stacks])
        run = {"rec": self._rec, "mlstm": self._mlstm,
               "slstm": self._slstm}[kind]
        h, new = run(ps, h, devs, sts)
        if kind == "rec":
            hn = self._norm(h, [p["ln2"] for p in ps], devs)
            h = coll.per_device(torch.add, devs, h,
                                self._mlp(ps, hn, devs))
        if stacks is not None:
            for st, nw in zip(stacks, new):
                for key, leaf in nw.items():
                    st[key][i].copy_(leaf)
        return h

    def _apply_block(self, kind, ps, h, positions, groups, states=None,
                     i=None, pos=None):
        """Layer ``i`` of ``kind`` over the groups in lockstep (per group
        lists of per-slot weights, activations and positions) -> (h per
        group, aux or None); ``states`` (per group, each slot's decode
        state) as ``run_groups``."""
        stacks = ([None] * len(groups) if states is None
                  else [[s[kind] for s in st] for st in states])
        if kind != "attn":
            return [self._state_block(kind, pg, hg, g.devs, sg, i)
                    for pg, hg, g, sg in zip(ps, h, groups, stacks)], None
        h = [self._attn_mix(pg, hg, pp, g.devs, sg, i, pos)
             for pg, hg, pp, g, sg in zip(ps, h, positions, groups, stacks)]
        return self._ffn(ps, h, groups)

    def _embed(self, trees, devs, tokens, extra_embeds):
        """Token embeddings, after the projected stub embeddings when
        ``extra_embeds`` (B, P, d) is given; a vocab-split table looks up
        the slot's rows (zero elsewhere), then ``all_reduce``s."""
        lay = self.layout
        if lay.vocab_split:
            parts = []
            for t, dev, (v0, vl) in zip(trees, devs, lay.vocab):
                loc = tokens.to(dev) - v0
                ok = (loc >= 0) & (loc < vl)
                parts.append(torch.where(
                    ok[..., None], t["embed"][loc.clamp(0, vl - 1)], 0))
            h = coll.all_reduce(parts, devs)
        else:
            h = coll.per_device(lambda t, d: embed_tokens(
                tokens.to(d), t["embed"]), devs, trees, devs)
        if extra_embeds is not None:
            def prefix(x, t):
                pe = extra_embeds.to(device=x.device, dtype=x.dtype)
                if "mm_proj" in t:
                    pe = pe @ t["mm_proj"]
                return torch.cat([pe, x], dim=1)
            h = coll.per_device(prefix, devs, h, trees)
        return h

    def _logits(self, trees, h, devs):
        """Each slot's logits over its vocabulary piece, padded columns
        masked."""
        lay, vocab = self.layout, self.cfg.vocab_size
        hn = self._norm(h, [t["out_norm"] for t in trees], devs)

        def one(x, t, v):
            return unembed(x, self._head(t), vocab, v[0])
        if lay.vocab_split:
            return [one(*a) for a in zip(hn, trees, lay.vocab)]
        return coll.per_device(one, devs, hn, trees, lay.vocab)

    def run_groups(self, groups, tokens, extra_embeds=None, states=None,
                   pos=None):
        """The model over ``groups`` in lockstep, layer by layer (each a
        ``Group``: its ``model`` slots' weight trees and devices, running
        its ``rows`` of ``tokens`` and ``extra_embeds``): a forward
        without ``states``, a prefill with them (per group, each slot's
        decode state, filled in place; the last position's logits), or a
        decode step with them and ``pos`` -> (per group the per-slot
        logits, aux loss float32)."""
        h, positions, layers = [], [], []
        kinds = dict.fromkeys(self.cfg.layer_kinds())
        for g in groups:
            dev = g.devs[0]
            hg = self._embed(g.trees, g.devs, tokens[g.rows].to(dev),
                             _rows(extra_embeds, g))
            l = hg[0].shape[1]
            positions.append(coll.per_device(lambda d: torch.arange(
                l, dtype=torch.int32, device=d) if pos is None else
                torch.full((1,), pos, dtype=torch.int32, device=d),
                g.devs, g.devs))
            layers.append([{kind: self.layers(t, kind) for kind in kinds}
                           for t in g.trees])
            h.append(hg)
        aux_total = torch.zeros((), dtype=torch.float32,
                                device=groups[0].devs[0])
        for kind, i in self._layers():
            ps = [[lt[kind][i] for lt in lg] for lg in layers]
            if states is None:
                h, aux = self._remat(functools.partial(
                    self._apply_block, kind))(ps, h, positions, groups)
            else:
                h, aux = self._apply_block(kind, ps, h, positions, groups,
                                           states, i, pos)
            if aux is not None:
                aux_total = aux_total + aux
        if states is not None and pos is None:
            h = [[x[:, -1:] for x in hg] for hg in h]
        return ([self._logits(g.trees, hg, g.devs)
                 for g, hg in zip(groups, h)], aux_total)

    def slot_groups(self, params, b: int) -> list:
        """The ``Group``s (``models.parallel``) that run a batch of ``b``
        rows: the mesh's ``(pod, data)`` groups on placed params, or off a
        mesh one slot holding ``params`` whole, on their device, with
        every row."""
        if self.plan is None:
            return [Group((0,), [params], [params["embed"].device],
                          slice(None))]
        return self.plan.groups_of(params, b)

    def _joined(self, per_group, shape):
        """The groups' per-slot logits as one tensor: off a mesh the one
        slot's, on a mesh a ``Sharded`` (batch over the data slots,
        vocabulary over the model slots)."""
        if self.plan is None:
            return per_group[0][0]
        return self.plan.sharded(per_group, shape, ("batch", None, "vocab"))

    # ---------------------------------------------------------------- #
    # forward (logits over the full sequence)
    # ---------------------------------------------------------------- #
    def forward(self, params, tokens, extra_embeds=None):
        """tokens (B, L) -> (logits (B, L', vocab_p), aux_loss float32),
        L' = L plus the stub tokens of ``extra_embeds``. On a mesh the
        logits are a ``Sharded`` and the aux loss the runs' mean (an MoE
        model's groups make one run: one aux loss over the batch)."""
        outs, auxs = [], []
        groups = self.slot_groups(params, tokens.shape[0])
        for run in lockstep(self.cfg, groups):
            lg, aux = self.run_groups(run, tokens, extra_embeds)
            outs += lg
            auxs.append(aux)
        shape = (tokens.shape[0], outs[0][0].shape[1], self.vocab_p)
        return self._joined(outs, shape), group_mean(auxs)

    def _remat(self, fn):
        """``fn`` under ``cfg.remat``'s checkpoint (see the module
        docstring); ``fn`` itself without grad mode or with ``"none"``."""
        mode = self.cfg.remat
        if mode == "none" or not torch.is_grad_enabled():
            return fn
        kw = {"context_fn": _dots_contexts} if mode == "dots" else {}
        return functools.partial(checkpoint, fn, use_reentrant=False, **kw)

    # ---------------------------------------------------------------- #
    # prefill: full-sequence forward that also fills the decode state
    # ---------------------------------------------------------------- #
    def prefill(self, params, tokens, cache_len: int, extra_embeds=None,
                dtype=torch.bfloat16):
        """Returns (last-token logits (B, 1, V), decode state at pos=L').

        The KV cache is made in ``dtype`` (bfloat16 by default, as in the
        reference) and must match the weights' dtype: float32 weights
        need ``dtype=torch.float32``, or the cache write raises. The other
        kinds' states are float32 whatever ``dtype``. On a mesh the
        logits are a ``Sharded`` and the state holds each slot's own
        (``{"groups": [[slot state, ...], ...]}``)."""
        outs, states = [], []
        groups = self.slot_groups(params, tokens.shape[0])
        for run in lockstep(self.cfg, groups):
            sts = [[self.init_decode_state(tokens[g.rows].shape[0],
                                           cache_len, dtype, d, slot=k)
                    for k, d in enumerate(g.devs)] for g in run]
            lg, _ = self.run_groups(run, tokens, extra_embeds, states=sts)
            outs += lg
            states += sts
        logits = self._joined(outs, (tokens.shape[0], 1, self.vocab_p))
        if self.plan is None:
            return logits, states[0][0]
        return logits, {"groups": states}

    # ---------------------------------------------------------------- #
    # decode
    # ---------------------------------------------------------------- #
    def init_decode_state(self, batch: int, seq_len: int,
                          dtype=torch.bfloat16, device=None,
                          slot: int = 0) -> dict:
        """Stacked per-layer decode state for every layer kind, on
        ``device`` (default: the first CUDA device; ``"meta"`` for a dry
        run): the KV caches in ``dtype``, zeros; the recurrent states
        float32, zeros with the stabilisers at -1e30. On a mesh, model
        slot ``slot``'s piece of it (its heads' caches; its piece of each
        state the layout splits, ``models/parallel.decode_state_axes``);
        off a mesh the whole."""
        cfg, dev, lay = self.cfg, resolve_device(device), self.layout
        kinds = cfg.layer_kinds()

        def piece(n, split):
            return n // lay.m if split else n

        def stacked(n, st):
            return {k: v[None].repeat(n, *([1] * v.dim()))
                    for k, v in st.items()}
        state: dict = {}
        if kinds.count("attn"):
            state["attn"] = attn.init_cache(kinds.count("attn"), batch,
                                            lay.attn[slot][0], seq_len,
                                            dtype, dev)
        if kinds.count("rec"):
            state["rec"] = stacked(kinds.count("rec"), rg.init_rglru_state(
                batch, piece(cfg.rg_lru_dim or cfg.d_model, lay.rec_split),
                cfg.conv1d_width, dev))
        if kinds.count("mlstm"):
            hd = ssm.UP * cfg.d_model // cfg.n_heads
            dv = piece(hd, lay.mlstm_cell_split)
            st = ssm.init_mlstm_state(batch, cfg.n_heads, hd, dv, dev)
            st["n"] = st["n"].new_zeros((batch, cfg.n_heads, dv))
            state["mlstm"] = stacked(kinds.count("mlstm"), st)
        if kinds.count("slstm"):
            state["slstm"] = stacked(kinds.count("slstm"),
                                     ssm.init_slstm_state(
                                         batch, piece(cfg.d_model,
                                                      lay.slstm_state_split),
                                         dev))
        return state

    def decode_step(self, params, token, pos: int, state):
        """token (B, 1) int; pos int. Returns (logits (B, 1, V), state),
        every layer's state updated in place."""
        per = iter([[state]] if self.plan is None else state["groups"])
        outs = []
        groups = self.slot_groups(params, token.shape[0])
        for run in lockstep(self.cfg, groups):
            outs += self.run_groups(run, token, pos=pos,
                                    states=[next(per) for _ in run])[0]
        return self._joined(outs, (token.shape[0], 1, self.vocab_p)), state


def _rows(x, group):
    """``x``'s rows of ``group`` on its first device (None stays None)."""
    return None if x is None else x[group.rows].to(group.devs[0])


def build(cfg: ModelConfig, tp: int = 1, mesh=None,
          rules: Rules | None = None) -> Model:
    """A model of ``cfg`` padded for ``tp``-way tensor parallelism, run
    over ``mesh`` if given (see ``Model``)."""
    return Model(cfg, tp, mesh, rules)
