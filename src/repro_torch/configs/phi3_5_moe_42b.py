"""phi3.5-moe-42b-a6.6b [moe] — 32L d4096 32H(kv8) ff6400 v32064, 16e top-2.

[hf:microsoft/Phi-3.5-MoE-instruct; hf]
"""
from .base import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-42b-a6.6b",
        family="moe",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=0,
        vocab_size=32064,
        moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=6400),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=0,
        vocab_size=211,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=96, capacity_factor=4.0),
        remat="none",
    )
