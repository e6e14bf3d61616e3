"""xlstm-350m [ssm] — 24L d1024 4H ff0 v50304, alternating sLSTM + mLSTM.

[arXiv:2405.04517; unverified]. Recurrent O(1)-in-seq state ->
long_500k RUNS. mLSTM uses the chunkwise-parallel formulation
(models/ssm.py); sLSTM is inherently sequential (recurrent gates).
"""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m",
        family="ssm",
        n_layers=24,
        d_model=1024,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab_size=50304,
        pattern=("slstm", "mlstm"),
        mlstm_chunk=128,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-smoke",
        family="ssm",
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab_size=131,
        pattern=("slstm", "mlstm"),
        mlstm_chunk=8,
        remat="none",
    )
