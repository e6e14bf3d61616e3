"""recurrentgemma-2b [hybrid] — 26L d2560 10H(kv1) ff7680 v256000,
RG-LRU + local attention, 1 attn : 2 recurrent.  [arXiv:2402.19427; hf]

Pattern (rec, rec, attn) cycled over 26 layers; local window 2048;
bounded state -> long_500k RUNS. 10 heads pad to 16 for 16-way TP; MQA
(kv=1) caches repeat-interleaved across the model axis.
"""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b",
        family="hybrid",
        n_layers=26,
        d_model=2560,
        n_heads=10,
        n_kv_heads=1,
        d_ff=7680,
        vocab_size=256000,
        pattern=("rec", "rec", "attn"),
        window=2048,
        rg_lru_dim=2560,
        head_dim=256,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-smoke",
        family="hybrid",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        d_ff=160,
        vocab_size=211,
        pattern=("rec", "rec", "attn"),
        window=8,
        rg_lru_dim=64,
        head_dim=16,
        remat="none",
    )
