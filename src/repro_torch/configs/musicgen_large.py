"""musicgen-large [audio] — 48L d2048 32H(kv32) ff8192 v2048.

Decoder-only over EnCodec tokens [arXiv:2306.05284; hf]. The EnCodec
frontend is a stub: the backbone consumes precomputed discrete codes
(models/frontend.py). Full attention -> long_500k skipped (DESIGN.md §6).
"""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large",
        family="audio",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        vocab_size=2048,
        frontend="audio",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-smoke",
        family="audio",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=128,
        frontend="audio",
        remat="none",
    )
