"""qwen2-moe-a2.7b [moe] — 24L d2048 16H(kv16) ff1408 v151936, 4 shared +
60 routed top-4.   [hf:Qwen/Qwen1.5-MoE-A2.7B; hf]

Shared experts are modeled as one always-on SwiGLU of width 4x1408 = 5632
(block-diagonal-equivalent compute; DESIGN.md §6). 60 routed experts are
padded to 64 for EP divisibility on the 16-way model axis.
"""
from .base import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b",
        family="moe",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=0,
        vocab_size=151936,
        qkv_bias=True,
        moe=MoEConfig(n_experts=60, top_k=4, d_ff_expert=1408,
                      n_shared=4, d_ff_shared=5632),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab_size=199,
        qkv_bias=True,
        moe=MoEConfig(n_experts=6, top_k=2, d_ff_expert=48,
                      n_shared=2, d_ff_shared=96, capacity_factor=4.0),
        remat="none",
    )
