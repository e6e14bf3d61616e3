"""llava-next-34b [vlm] — 60L d7168 56H(kv8) ff20480 v64000, anyres tiling.

[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]. Vision tower is a stub:
``input_specs`` supplies 576 precomputed patch embeddings (base anyres
tile) projected by ``mm_proj``. 56 heads pad to 64 for 16-way TP.
Full attention -> long_500k skipped.
"""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-34b",
        family="vlm",
        n_layers=60,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=20480,
        vocab_size=64000,
        frontend="vision",
        n_frontend_tokens=576,
        # 34B params: f32 gradients model-sharded only = 8.8 GB/device;
        # FSDP over the data axis is mandatory (§Perf follow-up to L2)
        fsdp=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llava-smoke",
        family="vlm",
        n_layers=2,
        d_model=56,
        n_heads=7,      # awkward head count (padding path)
        n_kv_heads=7,
        d_ff=128,
        vocab_size=241,
        frontend="vision",
        n_frontend_tokens=12,
        remat="none",
    )
