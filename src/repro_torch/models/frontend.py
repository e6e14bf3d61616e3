"""Modality frontend stubs.

The port of the JAX package's ``models/frontend.py``. The ``[audio]``
(musicgen) and ``[vlm]`` (llava-next) archs specify the transformer
backbone only; the EnCodec and vision-tower frontends are replaced by
precomputed inputs:

  * audio: the backbone consumes EnCodec token ids directly (vocab 2048),
    so no extra input is needed;
  * vision: ``patch_embeds (B, n_frontend_tokens, d_model)``, passed as
    ``extra_embeds`` to ``forward`` / ``prefill`` and projected there by
    ``mm_proj`` (576 patches: the canonical anyres base tile).

``frontend_input_specs`` gives the same inputs as ``meta`` tensors (a
dry run's abstract inputs).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device

__all__ = ["make_frontend_stub", "frontend_input_specs"]


def frontend_input_specs(cfg, batch: int) -> dict:
    """The frontend stub's extra inputs as ``meta`` tensors: the vision
    stub's bf16 ``extra_embeds`` (batch, n_frontend_tokens, d_model);
    {} for a model with no vision frontend."""
    if cfg.frontend == "vision":
        return {"extra_embeds": torch.empty(
            (batch, cfg.n_frontend_tokens, cfg.d_model),
            dtype=torch.bfloat16, device="meta")}
    return {}


def make_frontend_stub(cfg, batch: int, rng: np.random.Generator,
                       device=None) -> dict:
    """Materialised stub inputs, the reference's numpy draws (float64
    normal x 0.02) cast to bfloat16, on ``device`` (default: the first
    CUDA device); {} for a model with no vision frontend."""
    if cfg.frontend == "vision":
        x = rng.normal(size=(batch, cfg.n_frontend_tokens, cfg.d_model)) * 0.02
        return {"extra_embeds": torch.from_numpy(x).to(
            device=resolve_device(device), dtype=torch.bfloat16)}
    return {}
