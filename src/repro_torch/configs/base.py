"""Model and shape config dataclasses shared by every architecture (a
copy of the JAX package's `configs/base.py`, which imports nothing of JAX)."""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["MoEConfig", "ModelConfig", "ShapeConfig", "SHAPES"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int              # routed experts (padded for EP at build time)
    top_k: int
    d_ff_expert: int
    n_shared: int = 0           # always-on shared experts (qwen2-moe)
    d_ff_shared: int = 0        # total shared-expert hidden width
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | audio | vlm | ssm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    window: Optional[int] = None          # sliding-window attention size
    moe: Optional[MoEConfig] = None
    # layer pattern (hybrid/ssm): tuple of 'attn'|'rec'|'slstm'|'mlstm',
    # repeated/cycled to n_layers; None -> all 'attn'
    pattern: Optional[tuple] = None
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    frontend: Optional[str] = None        # 'audio' | 'vision' stubs
    n_frontend_tokens: int = 0            # stub prefix-embedding count
    dtype: str = "bfloat16"
    remat: str = "dots"                   # 'none' | 'dots' | 'full'
    scan_layers: bool = True              # False -> unroll (exact HLO cost)
    attn_chunk: int = 512                 # query-chunk size (flash rows)
    unroll_attn: bool = False             # Python-unroll the chunk loop
    attn_impl: str = "jnp"                # 'jnp' | 'flash' (CUDA kernel K7)
    fsdp: bool = False                    # shard big weights' embed dim on data
    # subquadratic archs support the long_500k decode shape
    rg_lru_dim: int = 0                   # recurrentgemma recurrence width
    conv1d_width: int = 4
    mlstm_chunk: int = 64

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def subquadratic(self) -> bool:
        return self.window is not None or self.family in ("ssm", "hybrid")

    def layer_kinds(self) -> tuple:
        if self.pattern is None:
            return ("attn",) * self.n_layers
        reps = -(-self.n_layers // len(self.pattern))
        return (self.pattern * reps)[: self.n_layers]


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
