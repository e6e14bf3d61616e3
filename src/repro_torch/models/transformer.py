"""Model assembly: param specs, forward, prefill, decode step.

The port of the JAX package's ``models/transformer.py`` for the dense
transformers (every layer ``"attn"`` with a SwiGLU MLP) on one device.
MoE, the recurrent layer kinds (``rec``, ``mlstm``, ``slstm``) and the
vision and audio frontends raise :class:`NotPortedError` when the model
is built.

Parameters are a plain nested dict of tensors, not parameters registered
on the module, so that one set of weights serves several builds (the
``"flash"`` and ``"jnp"`` attention paths) and maps one to one onto the
reference's tree: ``params["blocks"]["attn"]["attn"]["wq"]`` is the
reference's ``blocks.attn.attn.wq``, with the layer axis kept in front
as there. ``Model.layer`` is the one place that slices it; a Python loop
over layers replaces the reference's ``lax.scan``.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..core.device import resolve_device
from ..errors import NotPortedError
from . import attention as attn
from .layers import embed_tokens, mlp_specs, rms_norm, swiglu, unembed
from .params import Spec, tree_map

__all__ = ["Model", "build"]


class Model(torch.nn.Module):
    """A dense transformer of ``cfg``; holds no weights (see the module
    docstring). ``cfg.attn_impl`` picks the prefill attention:
    ``"flash"`` (kernel K7) or ``"jnp"`` (row-chunked plain PyTorch)."""

    def __init__(self, cfg: ModelConfig, tp: int = 1):
        super().__init__()
        if cfg.moe is not None:
            raise NotPortedError(f"{cfg.name}: mixture-of-experts layers "
                                 "(the moe family) are not ported")
        kinds = set(cfg.layer_kinds())
        if kinds != {"attn"}:
            raise NotPortedError(f"{cfg.name}: layer kinds {sorted(kinds)}; "
                                 "only 'attn' is ported (not rec, mlstm, "
                                 "slstm: the ssm and hybrid families)")
        if cfg.frontend is not None:
            raise NotPortedError(f"{cfg.name}: the {cfg.frontend} frontend "
                                 "(the audio and vlm families) is not ported")
        if cfg.attn_impl not in ("flash", "jnp"):
            raise ValueError(f"attn_impl must be 'flash' or 'jnp', got "
                             f"{cfg.attn_impl!r}")
        self.cfg = cfg
        self.dims = attn.make_dims(cfg, tp)     # raises unless tp == 1
        self.vocab_p = cfg.vocab_size      # tp=1: no vocab padding

    # ---------------------------------------------------------------- #
    # parameter specs
    # ---------------------------------------------------------------- #
    def param_specs(self) -> dict:
        cfg, d, n = self.cfg, self.cfg.d_model, self.cfg.n_layers
        specs: dict = {
            "embed": Spec((self.vocab_p, d), ("vocab", "embed")),
            "out_norm": Spec((d,), ("embed",), init="ones"),
        }
        if not cfg.tie_embeddings:
            specs["lm_head"] = Spec((d, self.vocab_p), ("embed_fsdp", "vocab"))
        block = {
            "ln1": Spec((n, d), ("layers", "embed"), init="ones"),
            "attn": attn.attn_specs(n, d, self.dims, cfg.qkv_bias),
            "ln2": Spec((n, d), ("layers", "embed"), init="ones"),
        }
        if cfg.d_ff:
            block["mlp"] = mlp_specs(n, d, cfg.d_ff)
        specs["blocks"] = {"attn": block}
        return specs

    @staticmethod
    def layer(params: dict, i: int) -> dict:
        """Layer ``i``'s weights: every leaf of ``params["blocks"]["attn"]``
        indexed on its leading (layer) axis, a view."""
        return tree_map(lambda a: a[i], params["blocks"]["attn"])

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

    def _mlp(self, p, h):
        if not self.cfg.d_ff:
            return h
        hn = rms_norm(h, p["ln2"], self.cfg.norm_eps)
        return h + swiglu(hn, p["mlp"]["wg"], p["mlp"]["wu"], p["mlp"]["wd"])

    def _logits(self, params, h):
        h = rms_norm(h, params["out_norm"], self.cfg.norm_eps)
        return unembed(h, self._head(params), self.cfg.vocab_size)

    # ---------------------------------------------------------------- #
    # forward (logits over the full sequence)
    # ---------------------------------------------------------------- #
    def forward(self, params, tokens):
        """tokens (B, L) -> (logits (B, L, vocab_p), aux_loss = 0)."""
        h = embed_tokens(tokens, params["embed"])
        positions = torch.arange(h.shape[1], dtype=torch.int32,
                                 device=h.device)
        for i in range(self.cfg.n_layers):
            p = self.layer(params, i)
            hn = rms_norm(h, p["ln1"], self.cfg.norm_eps)
            h = self._mlp(p, h + self._attend(p, hn, positions))
        return (self._logits(params, h),
                torch.zeros((), dtype=torch.float32, device=h.device))

    # ---------------------------------------------------------------- #
    # prefill: full-sequence forward that also fills the KV cache
    # ---------------------------------------------------------------- #
    def prefill(self, params, tokens, cache_len: int, dtype=torch.bfloat16):
        """Returns (last-token logits (B, 1, V), decode state at pos=L).

        The cache is made in ``dtype`` (bfloat16 by default, as in the
        reference) and must match the weights' dtype: float32 weights
        need ``dtype=torch.float32``, or the cache write raises."""
        cfg = self.cfg
        state = self.init_decode_state(tokens.shape[0], cache_len, dtype,
                                       device=tokens.device)
        cache = state["attn"]
        h = embed_tokens(tokens, params["embed"])
        positions = torch.arange(h.shape[1], dtype=torch.int32,
                                 device=h.device)
        for i in range(cfg.n_layers):
            p = self.layer(params, i)
            hn = rms_norm(h, p["ln1"], cfg.norm_eps)
            attn.prefill_kv_into_cache(p["attn"], hn, positions, self.dims,
                                       cfg.rope_theta, cache["k"][i],
                                       cache["v"][i])
            h = self._mlp(p, h + self._attend(p, hn, positions))
        return self._logits(params, h[:, -1:]), state

    # ---------------------------------------------------------------- #
    # decode
    # ---------------------------------------------------------------- #
    def init_decode_state(self, batch: int, seq_len: int,
                          dtype=torch.bfloat16, device=None) -> dict:
        """Stacked per-layer KV cache, zeros, on ``device`` (default: the
        first CUDA device)."""
        return {"attn": attn.init_cache(self.cfg.n_layers, batch, self.dims,
                                        seq_len, dtype,
                                        resolve_device(device))}

    def decode_step(self, params, token, pos: int, state):
        """token (B, 1) int; pos int. Returns (logits (B, 1, V), state),
        the state's cache updated in place."""
        cfg = self.cfg
        cache = state["attn"]
        h = embed_tokens(token, params["embed"])
        for i in range(cfg.n_layers):
            p = self.layer(params, i)
            hn = rms_norm(h, p["ln1"], cfg.norm_eps)
            out, _, _ = attn.decode_attention(p["attn"], hn, cache["k"][i],
                                              cache["v"][i], pos, self.dims,
                                              cfg.rope_theta)
            h = self._mlp(p, h + out)
        return self._logits(params, h), state


def build(cfg: ModelConfig, tp: int = 1) -> Model:
    return Model(cfg, tp)
