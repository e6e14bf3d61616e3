"""minitron-8b [dense] — 32L d4096 32H(kv8) ff16384 v256000 (pruned
nemotron).   [arXiv:2407.14679; hf]"""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minitron-8b",
        family="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=16384,
        vocab_size=256000,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="minitron-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=256,
        vocab_size=499,
        remat="none",
    )
