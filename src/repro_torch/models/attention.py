"""GQA attention: chunked-causal and flash prefill, KV-cache decode, windows.

The port of the JAX package's ``models/attention.py`` on one device
(``tp=1``: no query-head padding, the decode cache holds the model's own
KV heads). Prefill attention runs either row-chunked in plain PyTorch
(``attention``: query chunks bound the live scores to (B, H, chunk, Lkv),
and a windowed arch only slices the (window + chunk) KV band) or through
the flash kernel K7 (``flash_attention_block``). Decode is plain PyTorch:
one query against the (possibly ring) cache.

Unlike the reference, which returns new caches, the cache writers
(``prefill_kv_into_cache``, ``decode_attention``) write into the cache
tensors they are given and return them: the cache of a full-size model
is ~1 GB, and a functional update would copy it every layer and step.
Masked scores are -1e30, as in the reference, never -inf.
"""
from __future__ import annotations

import dataclasses

import torch

from ..errors import NotPortedError
from ..kernels import ops
from .layers import rope
from .params import Spec

__all__ = ["AttnDims", "attn_specs", "attention", "decode_attention",
           "flash_attention_block", "init_cache", "make_dims",
           "prefill_kv_into_cache"]

NEG = -1e30


@dataclasses.dataclass(frozen=True)
class AttnDims:
    n_heads: int        # real query heads
    n_heads_p: int      # padded to a multiple of tp
    n_kv: int           # real kv heads
    n_kv_cache: int     # kv heads stored in the decode cache
    head_dim: int
    window: int | None


def make_dims(cfg, tp: int = 1) -> AttnDims:
    """The reference's dims at ``tp=1``, where no padding or cache
    repetition occurs; tensor parallelism is not ported."""
    if tp != 1:
        raise NotPortedError(f"tensor parallelism (tp={tp}) is not ported; "
                             "the port runs one device (tp=1)")
    h, kv, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    return AttnDims(h, h, kv, kv, d, cfg.window)


# ---------------------------------------------------------------------- #
def attn_specs(layers: int, d_model: int, dims: AttnDims,
               qkv_bias: bool) -> dict:
    hp, kv, d = dims.n_heads_p, dims.n_kv, dims.head_dim
    sp = {
        "wq": Spec((layers, d_model, hp, d),
                   ("layers", "embed_fsdp", "heads", "head_dim")),
        "wk": Spec((layers, d_model, kv, d),
                   ("layers", "embed_fsdp", "kv_heads", "head_dim")),
        "wv": Spec((layers, d_model, kv, d),
                   ("layers", "embed_fsdp", "kv_heads", "head_dim")),
        "wo": Spec((layers, hp, d, d_model),
                   ("layers", "heads", "head_dim", "embed_fsdp")),
    }
    if qkv_bias:
        sp["bq"] = Spec((layers, hp, d), ("layers", "heads", "head_dim"),
                        init="zeros")
        sp["bk"] = Spec((layers, kv, d), ("layers", "kv_heads", "head_dim"),
                        init="zeros")
        sp["bv"] = Spec((layers, kv, d), ("layers", "kv_heads", "head_dim"),
                        init="zeros")
    return sp


def _head_mask(dims: AttnDims, dtype, device) -> torch.Tensor:
    return (torch.arange(dims.n_heads_p, device=device)
            < dims.n_heads).to(dtype)[:, None]


def _expand_kv(x: torch.Tensor, n_out: int) -> torch.Tensor:
    """(B, L, KV, D) -> (B, L, n_out, D) by repeat-interleave."""
    b, l, kv, d = x.shape
    if kv == n_out:
        return x
    if n_out % kv:
        raise ValueError(f"cannot expand {kv} kv heads to {n_out}")
    return x[:, :, :, None, :].expand(b, l, kv, n_out // kv, d).reshape(
        b, l, n_out, d)


def _qkv(p, x, dims: AttnDims, positions, theta):
    # p holds one layer's weights: wq (d, hp, hd) etc.
    q = torch.einsum("bld,dhk->blhk", x, p["wq"])
    k = torch.einsum("bld,dhk->blhk", x, p["wk"])
    v = torch.einsum("bld,dhk->blhk", x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = rope(q, positions, theta)
    k = rope(k, positions, theta)
    return q, k, v


def _out_proj(out, p, dims: AttnDims):
    if dims.n_heads_p != dims.n_heads:   # padded heads: exact no-ops
        out = out * _head_mask(dims, out.dtype, out.device)
    return torch.einsum("blhd,hdk->blk", out, p["wo"])


# ---------------------------------------------------------------------- #
# train / prefill: row-chunked causal attention, or the flash kernel
# ---------------------------------------------------------------------- #
def _chunk_attend(q_chunk, k, v, pos_q, pos_kv, window, scale):
    """q_chunk (B,C,H,D) vs k/v (B,Lk,H,D) -> (B,C,H,D)."""
    scores = torch.einsum("bchd,blhd->bhcl", q_chunk, k).float() * scale
    causal = pos_kv[None, :] <= pos_q[:, None]
    if window is not None:
        causal &= pos_kv[None, :] > (pos_q[:, None] - window)
    scores = scores.masked_fill(~causal[None, None], NEG)
    probs = torch.softmax(scores, dim=-1).to(q_chunk.dtype)
    return torch.einsum("bhcl,blhd->bchd", probs, v)


def flash_attention_block(p, x, positions, dims: AttnDims,
                          theta: float) -> torch.Tensor:
    """Full-sequence attention through the flash kernel K7 (its plain
    version on the CPU); the contract of ``attention``. K7 reads each
    query head's KV head in place: K and V are never expanded."""
    q, k, v = _qkv(p, x, dims, positions, theta)
    out = ops.flash_attention(q, k, v, window=dims.window)
    return _out_proj(out, p, dims)


def attention(p, x, positions, dims: AttnDims, theta: float,
              chunk: int = 512) -> torch.Tensor:
    """Causal self-attention over a full sequence, in query chunks of
    ``chunk`` rows (one chunk when ``chunk`` does not divide L)."""
    l = x.shape[1]
    q, k, v = _qkv(p, x, dims, positions, theta)
    k = _expand_kv(k, dims.n_heads_p)
    v = _expand_kv(v, dims.n_heads_p)
    scale = dims.head_dim ** -0.5
    chunk = min(chunk, l)
    if l % chunk != 0:
        chunk = l
    w = dims.window
    outs = []
    for cs in range(0, l, chunk):
        qc, pq = q[:, cs:cs + chunk], positions[cs:cs + chunk]
        if w is not None and l > (w + chunk):
            # banded KV slice: only the (window + chunk) tokens that can
            # attend
            band = w + chunk
            ks = max(cs + chunk - band, 0)
            outs.append(_chunk_attend(qc, k[:, ks:ks + band],
                                      v[:, ks:ks + band], pq,
                                      positions[ks:ks + band], w, scale))
        else:
            outs.append(_chunk_attend(qc, k, v, pq, positions, w, scale))
    return _out_proj(torch.cat(outs, dim=1), p, dims)


def _write(cache: torch.Tensor, index, x: torch.Tensor) -> None:
    if cache.dtype != x.dtype:
        raise TypeError(f"the KV cache is {cache.dtype} but the keys and "
                        f"values are {x.dtype}; pass dtype={x.dtype} to "
                        "prefill / init_decode_state")
    cache[:, index] = x


def prefill_kv_into_cache(p, x, positions, dims: AttnDims, theta,
                          cache_k, cache_v):
    """Write a full prompt's K/V into a (possibly ring) cache, in place.

    x (B, L, d); cache (B, Lc, KVC, D). For ring caches (window), slot s
    receives the *last* position p < L with p % Lc == s. Returns
    (cache_k, cache_v)."""
    _, k, v = _qkv(p, x, dims, positions, theta)
    k = _expand_kv(k, dims.n_kv_cache)
    v = _expand_kv(v, dims.n_kv_cache)
    l = k.shape[1]
    lc = cache_k.shape[1]
    if l >= lc:
        slots = torch.arange(lc, device=k.device)
        src = slots + lc * ((l - 1 - slots) // lc)        # last pos per slot
        _write(cache_k, slice(None), k[:, src])
        _write(cache_v, slice(None), v[:, src])
    else:
        _write(cache_k, slice(0, l), k)
        _write(cache_v, slice(0, l), v)
    return cache_k, cache_v


# ---------------------------------------------------------------------- #
# decode: single-token step against a (possibly ring) KV cache
# ---------------------------------------------------------------------- #
def init_cache(n_layers: int, batch: int, dims: AttnDims, seq_len: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """Cache length = window size for sliding-window archs (ring buffer)."""
    lc = min(dims.window, seq_len) if dims.window is not None else seq_len
    shape = (n_layers, batch, lc, dims.n_kv_cache, dims.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_attention(p, x, cache_k, cache_v, pos: int, dims: AttnDims,
                     theta: float):
    """One-token attention. x (B,1,d); cache_{k,v} (B,Lc,KVC,D); pos int.

    Writes the token's K/V into its slot of the cache and returns
    (out (B,1,d), cache_k, cache_v). The query heads attend in groups of
    H / KVC against their own cached KV head, which is the reference's
    product over the repeat-interleaved cache without building it."""
    b, lc = x.shape[0], cache_k.shape[1]
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    # q (B, 1, HP, D); k, v (B, 1, KV, D)
    q, k, v = _qkv(p, x, dims, positions, theta)
    k = _expand_kv(k, dims.n_kv_cache)
    v = _expand_kv(v, dims.n_kv_cache)
    slot = pos % lc if dims.window is not None else pos
    _write(cache_k, slot, k[:, 0])
    _write(cache_v, slot, v[:, 0])

    g, d = dims.n_kv_cache, dims.head_dim
    qg = q.reshape(b, 1, g, dims.n_heads_p // g, d)
    scale = d ** -0.5
    scores = torch.einsum("bqgrd,blgd->bgrql", qg, cache_k).float() * scale
    # slot s in a ring of length lc holds absolute position:
    slots = torch.arange(lc, device=x.device)
    if dims.window is not None:
        wrap = pos - ((pos - slots) % lc)             # latest abs pos at slot
        valid = (wrap >= 0) & (wrap <= pos) & (wrap > pos - dims.window)
    else:
        valid = slots <= pos
    scores = scores.masked_fill(~valid, NEG)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bgrql,blgd->bqgrd", probs, cache_v).reshape(
        b, 1, dims.n_heads_p, d)
    return _out_proj(out, p, dims), cache_k, cache_v
