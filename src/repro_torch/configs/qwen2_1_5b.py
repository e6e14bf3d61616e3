"""qwen2-1.5b [dense] — 28L d1536 12H(kv2) ff8960 v151936, GQA + QKV bias.

[arXiv:2407.10671; hf]. 12 heads are zero-mask-padded to 16 for the 16-way
model axis (exact no-op; DESIGN.md §4).
"""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-1.5b",
        family="dense",
        n_layers=28,
        d_model=1536,
        n_heads=12,
        n_kv_heads=2,
        d_ff=8960,
        vocab_size=151936,
        qkv_bias=True,
        rope_theta=1e6,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-smoke",
        family="dense",
        n_layers=2,
        d_model=48,
        n_heads=3,      # deliberately awkward head count (padding path)
        n_kv_heads=1,
        d_ff=128,
        vocab_size=151,
        qkv_bias=True,
        remat="none",
    )
