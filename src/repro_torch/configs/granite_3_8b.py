"""granite-3-8b [dense] — 40L d4096 32H(kv8) ff12800 v49155, GQA.

[hf:ibm-granite/granite-3.0-2b-base; hf]. Vocab 49155 is padded to 49168
(multiple of 16) for vocab sharding.
"""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-3-8b",
        family="dense",
        n_layers=40,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=12800,
        vocab_size=49155,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=160,
        vocab_size=179,  # prime: exercises vocab padding
        remat="none",
    )
