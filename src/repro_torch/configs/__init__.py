"""Architecture configs of the port. ``get_config(name)`` resolves every
arch the JAX package names, each family's included (dense, moe, audio,
vlm, ssm, hybrid)."""
from __future__ import annotations

import importlib

ARCHS = [
    "phi3_5_moe_42b",
    "qwen2_moe_a2_7b",
    "musicgen_large",
    "starcoder2_3b",
    "minitron_8b",
    "qwen2_1_5b",
    "granite_3_8b",
    "llava_next_34b",
    "xlstm_350m",
    "recurrentgemma_2b",
]

# public --arch ids (hyphenated) -> module names
ALIASES = {
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "musicgen-large": "musicgen_large",
    "starcoder2-3b": "starcoder2_3b",
    "minitron-8b": "minitron_8b",
    "qwen2-1.5b": "qwen2_1_5b",
    "granite-3-8b": "granite_3_8b",
    "llava-next-34b": "llava_next_34b",
    "xlstm-350m": "xlstm_350m",
    "recurrentgemma-2b": "recurrentgemma_2b",
}


def get_config(name: str, smoke: bool = False):
    mod_name = ALIASES.get(name, name)
    if mod_name not in ARCHS:
        raise ValueError(f"unknown arch {name!r}; known: {sorted(ALIASES)}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.smoke_config() if smoke else mod.config()
