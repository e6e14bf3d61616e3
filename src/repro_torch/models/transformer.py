"""Model assembly: param specs, forward, prefill, decode step.

The port of the JAX package's ``models/transformer.py`` on one device,
for every family: dense and MoE transformers (every layer ``"attn"``,
with a SwiGLU MLP or a mixture of experts), the vision and audio
backbones (their frontends are stubs, ``models/frontend.py``), and the
pattern archs whose layers cycle through ``"rec"`` (RG-LRU, hybrid),
``"mlstm"`` and ``"slstm"`` (xLSTM). Tensor parallelism (``tp > 1``)
raises :class:`NotPortedError` when the model is built.

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
from . import attention as attn
from . import moe as moe_mod
from . import rglru as rg
from . import ssm
from .layers import embed_tokens, mlp_specs, rms_norm, swiglu, unembed
from .params import Spec, tree_leaves, tree_map

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
    K7) or ``"jnp"`` (row-chunked plain PyTorch)."""

    def __init__(self, cfg: ModelConfig, tp: int = 1):
        super().__init__()
        if cfg.attn_impl not in ("flash", "jnp"):
            raise ValueError(f"attn_impl must be 'flash' or 'jnp', got "
                             f"{cfg.attn_impl!r}")
        if cfg.remat not in REMAT_MODES:
            raise ValueError(f"remat must be one of {REMAT_MODES}, got "
                             f"{cfg.remat!r}")
        self.cfg = cfg
        self.tp = tp
        self.dims = attn.make_dims(cfg, tp)     # raises unless tp == 1
        self.vocab_p = cfg.vocab_size      # tp=1: no vocab padding
        self.n_experts_p = (moe_mod.pad_experts(cfg.moe.n_experts, tp)
                            if cfg.moe else 0)

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

    def _all_layers(self, params: dict):
        """(kind, index within the kind, weights) for every layer, in
        order, each kind's stack sliced once."""
        stacks = {kind: self.layers(params, kind)
                  for kind in dict.fromkeys(self.cfg.layer_kinds())}
        for kind, i in self._layers():
            yield kind, i, stacks[kind][i]

    def _layers(self):
        """(kind, index within the kind) for every layer, in order."""
        seen: dict = {}
        for kind in self.cfg.layer_kinds():
            seen[kind] = seen.get(kind, 0) + 1
            yield kind, seen[kind] - 1

    def _head(self, params):
        return params["lm_head"] if "lm_head" in params else params["embed"].T

    # ---------------------------------------------------------------- #
    # one layer (weights already sliced)
    # ---------------------------------------------------------------- #
    def _attend(self, p, hn, positions):
        cfg = self.cfg
        if cfg.attn_impl == "flash":
            return attn.flash_attention_block(p["attn"], hn, positions,
                                              self.dims, cfg.rope_theta)
        return attn.attention(p["attn"], hn, positions, self.dims,
                              cfg.rope_theta, chunk=cfg.attn_chunk)

    def _ffn(self, p, h):
        """The attention block's second half -> (h, aux loss or None): the
        experts (and their aux loss), the MLP, or nothing."""
        cfg = self.cfg
        if cfg.moe is None and not cfg.d_ff:
            return h, None
        hn = rms_norm(h, p["ln2"], cfg.norm_eps)
        if cfg.moe is not None:
            out, aux = moe_mod.moe_block(p["moe"], hn, cfg.moe,
                                         self.n_experts_p)
            return h + out, aux
        return h + swiglu(hn, p["mlp"]["wg"], p["mlp"]["wu"],
                          p["mlp"]["wd"]), None

    def _apply_block(self, kind, p, h, positions, state=None, cache=None,
                     pos=None):
        """One layer -> (h, aux or None, state or None).

        ``"attn"``: ``cache`` (the layer's k, v) with ``pos`` is a decode
        step against it; ``cache`` alone is a prefill that fills it; no
        cache is the full-sequence forward. The other kinds run from
        ``state`` (None: fresh zeros) and return their new state."""
        cfg = self.cfg
        if kind == "attn":
            hn = rms_norm(h, p["ln1"], cfg.norm_eps)
            if pos is not None:
                out, _, _ = attn.decode_attention(
                    p["attn"], hn, cache["k"], cache["v"], pos, self.dims,
                    cfg.rope_theta)
            else:
                if cache is not None:
                    attn.prefill_kv_into_cache(
                        p["attn"], hn, positions, self.dims, cfg.rope_theta,
                        cache["k"], cache["v"])
                out = self._attend(p, hn, positions)
            h, aux = self._ffn(p, h + out)
            return h, aux, None
        if kind == "rec":
            h, state = rg.rglru_block(p["rec"], h, cfg.conv1d_width,
                                      cfg.norm_eps, state)
            hn = rms_norm(h, p["ln2"], cfg.norm_eps)
            out = swiglu(hn, p["mlp"]["wg"], p["mlp"]["wu"], p["mlp"]["wd"])
            return h + out, None, state
        if kind == "mlstm":
            h, state = ssm.mlstm_block(p["cell"], h, cfg.n_heads,
                                       cfg.norm_eps, cfg.mlstm_chunk, state)
            return h, None, state
        if kind == "slstm":
            h, state = ssm.slstm_block(p["cell"], h, cfg.n_heads,
                                       cfg.norm_eps, state)
            return h, None, state
        raise ValueError(kind)

    def _embed(self, params, tokens, extra_embeds):
        """Token embeddings, after the projected stub embeddings when
        ``extra_embeds`` (B, P, d) is given."""
        h = embed_tokens(tokens, params["embed"])
        if extra_embeds is not None:
            pe = extra_embeds.to(h.dtype)
            if "mm_proj" in params:
                pe = pe @ params["mm_proj"]
            h = torch.cat([pe, h], dim=1)
        return h

    def _logits(self, params, h):
        h = rms_norm(h, params["out_norm"], self.cfg.norm_eps)
        return unembed(h, self._head(params), self.cfg.vocab_size)

    # ---------------------------------------------------------------- #
    # forward (logits over the full sequence)
    # ---------------------------------------------------------------- #
    def forward(self, params, tokens, extra_embeds=None):
        """tokens (B, L) -> (logits (B, L', vocab_p), aux_loss float32),
        L' = L plus the stub tokens of ``extra_embeds``."""
        h = self._embed(params, tokens, extra_embeds)
        positions = torch.arange(h.shape[1], dtype=torch.int32,
                                 device=h.device)
        aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
        for kind, _, p in self._all_layers(params):
            h, aux, _ = self._remat(functools.partial(self._apply_block,
                                                      kind))(p, h, positions)
            if aux is not None:
                aux_total = aux_total + aux
        return self._logits(params, h), aux_total

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
        kinds' states are float32 whatever ``dtype``."""
        state = self.init_decode_state(tokens.shape[0], cache_len, dtype,
                                       device=tokens.device)
        h = self._embed(params, tokens, extra_embeds)
        positions = torch.arange(h.shape[1], dtype=torch.int32,
                                 device=h.device)
        for kind, i, p in self._all_layers(params):
            if kind == "attn":
                cache = {"k": state["attn"]["k"][i],
                         "v": state["attn"]["v"][i]}
                h, _, _ = self._apply_block(kind, p, h, positions,
                                            cache=cache)
            else:
                # from the fresh state, so the final state comes back
                h, _, st = self._apply_block(
                    kind, p, h, positions,
                    state=tree_map(lambda a: a[i], state[kind]))
                self._store(state[kind], i, st)
        return self._logits(params, h[:, -1:]), state

    @staticmethod
    def _store(stack: dict, i: int, st: dict) -> None:
        """Write one layer's new state into slot ``i`` of its stack."""
        for key, leaf in st.items():
            stack[key][i].copy_(leaf)

    # ---------------------------------------------------------------- #
    # decode
    # ---------------------------------------------------------------- #
    def init_decode_state(self, batch: int, seq_len: int,
                          dtype=torch.bfloat16, device=None) -> dict:
        """Stacked per-layer decode state for every layer kind, on
        ``device`` (default: the first CUDA device): the KV caches in
        ``dtype``, zeros; the recurrent states float32, zeros with the
        stabilisers at -1e30."""
        cfg, dev = self.cfg, resolve_device(device)
        kinds = cfg.layer_kinds()

        def stacked(n, st):
            return {k: v[None].repeat(n, *([1] * v.dim()))
                    for k, v in st.items()}
        state: dict = {}
        if kinds.count("attn"):
            state["attn"] = attn.init_cache(kinds.count("attn"), batch,
                                            self.dims, seq_len, dtype, dev)
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
        h = embed_tokens(token, params["embed"])
        positions = torch.full((1,), pos, dtype=torch.int32, device=h.device)
        for kind, i, p in self._all_layers(params):
            if kind == "attn":
                cache = {"k": state["attn"]["k"][i],
                         "v": state["attn"]["v"][i]}
                h, _, _ = self._apply_block(kind, p, h, positions,
                                            cache=cache, pos=pos)
            else:
                h, _, st = self._apply_block(
                    kind, p, h, positions,
                    state=tree_map(lambda a: a[i], state[kind]))
                self._store(state[kind], i, st)
        return self._logits(params, h), state


def build(cfg: ModelConfig, tp: int = 1) -> Model:
    return Model(cfg, tp)
