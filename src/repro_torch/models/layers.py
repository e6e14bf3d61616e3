"""Shared layers: RMSNorm, RoPE, SwiGLU MLP, embeddings.

Each keeps the JAX package's dtype steps (``models/layers.py``): the
norm computes in float32 and casts back before the weight multiplies,
the rotary frequencies and angles are float32, and padded vocabulary
columns are masked with the dtype's most negative finite value.
``with_sharding_constraint_logical`` places an activation on a mesh's
slots by its logical axes (the reference's sharding annotation).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..sharding.placed import Sharded, shard, unshard
from ..sharding.rules import named_sharding
from .params import Spec

__all__ = ["rms_norm", "rope", "swiglu", "embed_tokens", "unembed",
           "norm_spec", "mlp_specs", "with_sharding_constraint_logical"]


def with_sharding_constraint_logical(x, mesh, rules, axes):
    """``x`` placed on ``mesh``'s slots by its logical ``axes`` (a
    ``Sharded``; one already placed otherwise is re-placed, one placed so
    is returned as it is). Without a mesh (``mesh=None``) it is ``x``
    itself, as the reference's is outside a mesh context."""
    if mesh is None:
        return x
    placement = named_sharding(mesh, rules, axes, tuple(x.shape))
    if isinstance(x, Sharded):
        if x.placement == placement:
            return x
        x = unshard(x)
    return shard(x, placement)


# ---------------------------------------------------------------------- #
def norm_spec(d_model: int, layers: int | None = None) -> Spec:
    shape = (d_model,) if layers is None else (layers, d_model)
    axes = ("embed",) if layers is None else ("layers", "embed")
    return Spec(shape, axes, init="ones")


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * w


# ---------------------------------------------------------------------- #
def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding. x: (..., L, H, D); positions: (..., L)."""
    d = x.shape[-1]
    half = d // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = torch.pow(theta, exps)   # float32, theta never leaves the host
    angles = positions[..., None].float() * freqs   # (..., L, half)
    cos = torch.cos(angles)[..., None, :]            # (..., L, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------- #
def mlp_specs(layers: int, d_model: int, d_ff: int) -> dict:
    return {
        "wg": Spec((layers, d_model, d_ff), ("layers", "embed_fsdp", "mlp")),
        "wu": Spec((layers, d_model, d_ff), ("layers", "embed_fsdp", "mlp")),
        "wd": Spec((layers, d_ff, d_model), ("layers", "mlp", "embed_fsdp")),
    }


def swiglu(x: torch.Tensor, wg, wu, wd) -> torch.Tensor:
    h = F.silu(x @ wg) * (x @ wu)
    return h @ wd


# ---------------------------------------------------------------------- #
def embed_tokens(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` for integer ``tokens``."""
    return table[tokens]


def unembed(x: torch.Tensor, head: torch.Tensor, vocab_size: int,
            first: int = 0) -> torch.Tensor:
    """Logits with padded-vocab masking (padded columns -> dtype min);
    ``head`` holds the vocabulary's columns ``first ..`` (a slot's piece
    on a mesh)."""
    logits = x @ head
    vp = head.shape[-1]
    if first + vp > vocab_size:
        mask = torch.arange(first, first + vp,
                            device=logits.device) < vocab_size
        logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
    return logits
