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
params placed by ``Model.place``. Both run one body, ``run_group``:
the layers over one group's ``model`` slots, each slot on its weights'
pieces with the collectives between them; off a mesh the group is one
slot holding the whole model, and every collective is the identity.

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
from .parallel import Group, MeshPlan, SlotLayout, group_mean
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

    def _attend(self, p, hn, positions, dims, kv_select):
        cfg = self.cfg
        if cfg.attn_impl == "flash":
            return attn.flash_attention_block(p["attn"], hn, positions, dims,
                                              cfg.rope_theta, kv_select)
        return attn.attention(p["attn"], hn, positions, dims, cfg.rope_theta,
                              chunk=cfg.attn_chunk, unroll=cfg.unroll_attn,
                              kv_select=kv_select)

    def _attn_block(self, ps, h, positions, devs, caches=None, i=None,
                    pos=None):
        """One attention layer -> (h per slot, aux or None). Each slot runs
        its own query heads; their partial out-projections are
        ``all_reduce``d where the heads are split. ``caches`` (each slot's
        k, v stacks) with ``pos`` is a decode step against layer ``i``'s;
        ``caches`` alone a prefill that fills them; neither the
        full-sequence forward."""
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
        return self._ffn(ps, coll.per_device(torch.add, devs, h, outs), devs)

    def _ffn(self, ps, h, devs):
        """The attention block's second half -> (h, aux loss or None): the
        experts (and their aux loss), the MLP, or nothing."""
        cfg, lay = self.cfg, self.layout
        if cfg.moe is None and not cfg.d_ff:
            return h, None
        hn = self._norm(h, [p["ln2"] for p in ps], devs)
        aux = None
        if cfg.moe is not None:
            out, aux = self._experts(ps, hn, devs)
        elif lay.mlp_split:
            out = coll.all_reduce([swiglu(x, p["mlp"]["wg"], p["mlp"]["wu"],
                                          p["mlp"]["wd"])
                                   for x, p in zip(hn, ps)], devs)
        else:
            out = coll.per_device(lambda x, p: swiglu(
                x, p["mlp"]["wg"], p["mlp"]["wu"], p["mlp"]["wd"]), devs,
                hn, ps)
        return coll.per_device(torch.add, devs, h, out), aux

    def _experts(self, ps, hn, devs):
        """The experts over the group's slots (expert parallelism where
        they are split) -> (out per slot, aux): one routing of all the
        experts, made from the router logits (``all_gather``ed from the
        slots' columns), each slot's experts' share, ``all_reduce``d."""
        moe, e, lay = self.cfg.moe, self.n_experts_p, self.layout
        xts = [x.reshape(-1, x.shape[-1]) for x in hn]
        logits = [x @ p["moe"]["router"] for x, p in zip(xts, ps)]
        if lay.experts_split:
            logits = coll.all_gather(logits, 1, devs)
        routing = moe_mod.route(ps[0]["moe"]["router"], xts[0], moe, e,
                                logits=logits[0])
        routings = coll.per_device(
            lambda d: tuple(r.to(d) for r in routing), devs, devs)
        routed, shared, aux = [], [], None
        for m, p in enumerate(ps):
            r, sh, a = moe_mod.moe_parts(p["moe"], hn[m], moe, e,
                                         experts=lay.experts[m],
                                         routing=routings[m])
            aux = a if aux is None else aux
            if sh is not None and lay.shared_split:
                r = r + sh
            elif sh is not None:
                shared.append(sh)
            routed.append(r)
        if lay.experts_split:
            routed = coll.all_reduce(routed, devs)
        if shared:
            routed = [r + s for r, s in zip(routed, shared)]
        return routed, aux

    def _state_block(self, kind, ps, h, stacks=None, i=None):
        """One layer of a recurrent kind on each slot (these run on groups
        of one ``model`` slot) -> (h per slot, None): from layer ``i``'s
        state in ``stacks`` (each slot's, written back in place), else
        from fresh zeros."""
        cfg = self.cfg
        out = []
        for m, (p, x) in enumerate(zip(ps, h)):
            st = None if stacks is None else tree_map(lambda a: a[i],
                                                      stacks[m])
            if kind == "rec":
                x, st = rg.rglru_block(p["rec"], x, cfg.conv1d_width,
                                       cfg.norm_eps, st)
                x = x + swiglu(rms_norm(x, p["ln2"], cfg.norm_eps),
                               p["mlp"]["wg"], p["mlp"]["wu"], p["mlp"]["wd"])
            elif kind == "mlstm":
                x, st = ssm.mlstm_block(p["cell"], x, cfg.n_heads,
                                        cfg.norm_eps, cfg.mlstm_chunk, st)
            elif kind == "slstm":
                x, st = ssm.slstm_block(p["cell"], x, cfg.n_heads,
                                        cfg.norm_eps, st)
            else:
                raise ValueError(kind)
            if stacks is not None:
                for key, leaf in st.items():
                    stacks[m][key][i].copy_(leaf)
            out.append(x)
        return out, None

    def _apply_block(self, kind, ps, h, positions, devs, states=None,
                     i=None, pos=None):
        """Layer ``i`` of ``kind`` over the group's slots -> (h, aux or
        None); ``states`` (each slot's decode state) as ``run_group``."""
        stacks = None if states is None else [s[kind] for s in states]
        if kind == "attn":
            return self._attn_block(ps, h, positions, devs, stacks, i, pos)
        return self._state_block(kind, ps, h, stacks, i)

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

    def run_group(self, trees, devs, tokens, extra_embeds=None, states=None,
                  pos=None):
        """The model over one group's ``model`` slots (each slot's weight
        tree and device): a forward without ``states``, a prefill with
        them (each slot's decode state, filled in place; the last
        position's logits), or a decode step with them and ``pos`` ->
        (per-slot logits, aux loss float32)."""
        h = self._embed(trees, devs, tokens, extra_embeds)
        l = h[0].shape[1]
        positions = coll.per_device(lambda d: torch.arange(
            l, dtype=torch.int32, device=d) if pos is None else torch.full(
            (1,), pos, dtype=torch.int32, device=d), devs, devs)
        layers = [{kind: self.layers(t, kind)
                   for kind in dict.fromkeys(self.cfg.layer_kinds())}
                  for t in trees]
        aux_total = torch.zeros((), dtype=torch.float32, device=devs[0])
        for kind, i in self._layers():
            ps = [lt[kind][i] for lt in layers]
            if states is None:
                h, aux = self._remat(functools.partial(
                    self._apply_block, kind))(ps, h, positions, devs)
            else:
                h, aux = self._apply_block(kind, ps, h, positions, devs,
                                           states, i, pos)
            if aux is not None:
                aux_total = aux_total + aux
        if states is not None and pos is None:
            h = [x[:, -1:] for x in h]
        return self._logits(trees, h, devs), aux_total

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
        logits are a ``Sharded`` and the aux loss the groups' mean."""
        outs, auxs = [], []
        for g in self.slot_groups(params, tokens.shape[0]):
            lg, aux = self.run_group(g.trees, g.devs, tokens[g.rows].to(
                g.devs[0]), _rows(extra_embeds, g))
            outs.append(lg)
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
        for g in self.slot_groups(params, tokens.shape[0]):
            toks = tokens[g.rows].to(g.devs[0])
            st = [self.init_decode_state(toks.shape[0], cache_len, dtype,
                                         d, dims)
                  for d, (dims, _) in zip(g.devs, self.layout.attn)]
            lg, _ = self.run_group(g.trees, g.devs, toks,
                                   _rows(extra_embeds, g), states=st)
            outs.append(lg)
            states.append(st)
        logits = self._joined(outs, (tokens.shape[0], 1, self.vocab_p))
        if self.plan is None:
            return logits, states[0][0]
        return logits, {"groups": states}

    # ---------------------------------------------------------------- #
    # decode
    # ---------------------------------------------------------------- #
    def init_decode_state(self, batch: int, seq_len: int,
                          dtype=torch.bfloat16, device=None,
                          dims=None) -> dict:
        """Stacked per-layer decode state for every layer kind, on
        ``device`` (default: the first CUDA device): the KV caches in
        ``dtype``, zeros, of ``dims`` (default: the model's; a slot's
        on a mesh); the recurrent states float32, zeros with the
        stabilisers at -1e30."""
        cfg, dev = self.cfg, resolve_device(device)
        kinds = cfg.layer_kinds()

        def stacked(n, st):
            return {k: v[None].repeat(n, *([1] * v.dim()))
                    for k, v in st.items()}
        state: dict = {}
        if kinds.count("attn"):
            state["attn"] = attn.init_cache(kinds.count("attn"), batch,
                                            dims or self.dims, seq_len,
                                            dtype, dev)
        if kinds.count("rec"):
            state["rec"] = stacked(kinds.count("rec"), rg.init_rglru_state(
                batch, cfg.rg_lru_dim or cfg.d_model, cfg.conv1d_width, dev))
        if kinds.count("mlstm"):
            hd = ssm.UP * cfg.d_model // cfg.n_heads
            state["mlstm"] = stacked(kinds.count("mlstm"),
                                     ssm.init_mlstm_state(batch, cfg.n_heads,
                                                          hd, hd, dev))
        if kinds.count("slstm"):
            state["slstm"] = stacked(kinds.count("slstm"),
                                     ssm.init_slstm_state(batch, cfg.d_model,
                                                          dev))
        return state

    def decode_step(self, params, token, pos: int, state):
        """token (B, 1) int; pos int. Returns (logits (B, 1, V), state),
        every layer's state updated in place."""
        groups = self.slot_groups(params, token.shape[0])
        per = [[state]] if self.plan is None else state["groups"]
        outs = [self.run_group(g.trees, g.devs, token[g.rows].to(g.devs[0]),
                               states=st, pos=pos)[0]
                for g, st in zip(groups, per)]
        return self._joined(outs, (token.shape[0], 1, self.vocab_p)), state


def _rows(x, group):
    """``x``'s rows of ``group`` on its first device (None stays None)."""
    return None if x is None else x[group.rows].to(group.devs[0])


def build(cfg: ModelConfig, tp: int = 1, mesh=None,
          rules: Rules | None = None) -> Model:
    """A model of ``cfg`` padded for ``tp``-way tensor parallelism, run
    over ``mesh`` if given (see ``Model``)."""
    return Model(cfg, tp, mesh, rules)
