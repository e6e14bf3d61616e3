"""GQA attention: chunked-causal and flash prefill, KV-cache decode, windows.

The port of the JAX package's ``models/attention.py``. Prefill attention
runs either row-chunked in plain PyTorch (``attention``: query chunks
bound the live scores to (B, H, chunk, Lkv), and a windowed arch only
slices the (window + chunk) KV band) or through the flash kernel K7
(``flash_attention_block``). Decode is plain PyTorch: one query against
the (possibly ring) cache.

TP-awareness, as in the reference (``make_dims``):
  * query heads are zero-masked-padded to a multiple of ``tp``
    (``AttnDims.n_heads_p``); padded heads are exact no-ops (their
    attention output is masked before the out-projection);
  * KV heads with ``kv % tp != 0`` are replicated (the rules' fallback);
    the decode cache stores KV repeated to ``n_kv_cache`` heads
    (repeat-interleave) so decode attention needs no collective. Query
    head ``j`` reads KV head ``j // (n_heads_p / n_kv)``: the grouping is
    defined on the padded head count, so a build at one ``tp`` is held
    against the reference's at the same ``tp``, never at another.

On a mesh (``models/transformer``) each ``model`` slot runs these
functions on its own heads: its slices of the weights, dims from
``slot_dims``, and ``kv_select``, the KV heads of the slot's weights
that its query heads read (a slice, or an index where the heads do not
fall in equal groups).

Unlike the reference, which returns new caches, the cache writers
(``prefill_kv_into_cache``, ``decode_attention``) write into the cache
tensors they are given and return them: the cache of a full-size model
is ~1 GB, and a functional update would copy it every layer and step.
Masked scores are -1e30, as in the reference, never -inf.
"""
from __future__ import annotations

import dataclasses

import torch

from ..kernels import ops
from ..sharding.rules import pad_to_multiple
from .layers import rope
from .params import Spec

__all__ = ["AttnDims", "attn_specs", "attention", "decode_attention",
           "flash_attention_block", "init_cache", "make_dims",
           "prefill_kv_into_cache", "slot_dims", "check_grouping"]

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
    """The reference's dims at ``tp``: heads padded to a multiple of
    ``tp``; the cache holds the KV heads when ``tp`` divides them, else
    repeats them to ``tp`` heads when they divide ``tp``, else keeps them
    (replicated)."""
    h, kv, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    hp = h if h % tp == 0 else pad_to_multiple(h, tp)
    if kv % tp == 0:
        kvc = kv
    elif tp % kv == 0:
        kvc = tp              # repeat-interleave to the TP width
    else:
        kvc = kv              # replicated fallback
    return AttnDims(h, hp, kv, kvc, d, cfg.window)


def check_grouping(dims: AttnDims, tp: int) -> None:
    """Raise where the reference's ``_expand_kv`` asserts: the padded
    query heads must fall in equal groups on the KV heads, and the cache
    heads on them (llava-next's smoke config at ``tp=2`` has 8 padded
    heads on 7 KV heads). The reference fails when it first runs an
    attention layer; the port, when the model is built."""
    for n_out in (dims.n_heads_p, dims.n_kv_cache):
        if n_out % dims.n_kv:
            raise ValueError(
                f"tp={tp}: {dims.n_heads} query heads padded to "
                f"{dims.n_heads_p} (cache {dims.n_kv_cache}) do not group "
                f"on {dims.n_kv} KV heads; the reference's _expand_kv "
                "asserts here too")


def slot_dims(dims: AttnDims, first: int, count: int, kv_first: int,
              kv_count: int):
    """The dims of a slot holding query heads ``first .. first+count-1``
    and the KV weights of heads ``kv_first .. kv_first+kv_count-1`` ->
    (its ``AttnDims``, ``kv_select``). Its real heads are those below
    ``n_heads`` (padding is trailing); it reads KV head ``j // g`` for its
    query head ``j`` (``g = n_heads_p / n_kv``) and caches exactly the KV
    heads it reads: a slice when they give its heads equal groups, else
    one per query head."""
    g = dims.n_heads_p // dims.n_kv
    need = [(first + j) // g - kv_first for j in range(count)]
    if min(need) < 0 or max(need) >= kv_count:
        raise ValueError(f"query heads {first}..{first + count - 1} read KV "
                         f"heads outside the slot's {kv_first}.."
                         f"{kv_first + kv_count - 1}")
    n_sel = need[-1] - need[0] + 1
    if count % n_sel == 0 and need == [need[0] + j // (count // n_sel)
                                       for j in range(count)]:
        sel = slice(need[0], need[-1] + 1)
        if n_sel == kv_count:
            sel = None
    else:
        sel, n_sel = torch.tensor(need, dtype=torch.long), count
    real = min(max(dims.n_heads - first, 0), count)
    return AttnDims(real, count, n_sel, n_sel, dims.head_dim,
                    dims.window), sel


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


def _qkv(p, x, dims: AttnDims, positions, theta, kv_select=None):
    # p holds one layer's weights: wq (d, hp, hd) etc.; kv_select picks
    # the KV heads this slot reads before they are projected
    wk, wv = p["wk"], p["wv"]
    if kv_select is not None:
        wk, wv = wk[:, kv_select], wv[:, kv_select]
    q = torch.einsum("bld,dhk->blhk", x, p["wq"])
    k = torch.einsum("bld,dhk->blhk", x, wk)
    v = torch.einsum("bld,dhk->blhk", x, wv)
    if "bq" in p:
        bk, bv = p["bk"], p["bv"]
        if kv_select is not None:
            bk, bv = bk[kv_select], bv[kv_select]
        q, k, v = q + p["bq"], k + bk, v + bv
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
                          theta: float, kv_select=None) -> torch.Tensor:
    """Full-sequence attention through the flash kernel K7 (its plain
    version on the CPU); the contract of ``attention``. K7 reads each
    query head's KV head in place: K and V are never expanded (the
    group is ``n_heads_p / KV``, padded heads included)."""
    q, k, v = _qkv(p, x, dims, positions, theta, kv_select)
    out = ops.flash_attention(q, k, v, window=dims.window)
    return _out_proj(out, p, dims)


def attention(p, x, positions, dims: AttnDims, theta: float,
              chunk: int = 512, unroll: bool = False,
              kv_select=None) -> torch.Tensor:
    """Causal self-attention over a full sequence, in query chunks of
    ``chunk`` rows (one chunk when ``chunk`` does not divide L).

    ``unroll`` is the reference's switch from a ``lax.map`` over the
    chunks to a Python loop (so its cost analysis sees every chunk); the
    port's chunk loop is a Python loop either way, so it changes no
    number and is accepted for the reference's signature."""
    del unroll
    l = x.shape[1]
    q, k, v = _qkv(p, x, dims, positions, theta, kv_select)
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
                          cache_k, cache_v, kv_select=None):
    """Write a full prompt's K/V into a (possibly ring) cache, in place.

    x (B, L, d); cache (B, Lc, KVC, D). For ring caches (window), slot s
    receives the *last* position p < L with p % Lc == s. Returns
    (cache_k, cache_v)."""
    _, k, v = _qkv(p, x, dims, positions, theta, kv_select)
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
                     theta: float, kv_select=None):
    """One-token attention. x (B,1,d); cache_{k,v} (B,Lc,KVC,D); pos int.

    Writes the token's K/V into its slot of the cache and returns
    (out (B,1,d), cache_k, cache_v). The query heads attend in groups of
    H / KVC against their own cached KV head, which is the reference's
    product over the repeat-interleaved cache without building it."""
    b, lc = x.shape[0], cache_k.shape[1]
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    # q (B, 1, HP, D); k, v (B, 1, KV, D)
    q, k, v = _qkv(p, x, dims, positions, theta, kv_select)
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
