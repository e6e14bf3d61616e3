"""starcoder2-3b [dense] — 30L d3072 24H(kv2) ff12288 v49152, GQA + RoPE.

[arXiv:2402.19173; hf]. StarCoder2 uses sliding-window attention (4096),
which makes it sub-quadratic: long_500k RUNS with a windowed ring cache.
"""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-3b",
        family="dense",
        n_layers=30,
        d_model=3072,
        n_heads=24,
        n_kv_heads=2,
        d_ff=12288,
        vocab_size=49152,
        window=4096,
        rope_theta=1e5,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=192,
        vocab_size=193,
        window=8,
        remat="none",
    )
