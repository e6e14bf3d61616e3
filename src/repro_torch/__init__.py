"""PyTorch/CUDA port of the candidate-free R-S set similarity join.

The public surface mirrors the JAX package's front door::

    import repro_torch
    result = repro_torch.join(R, S, 0.8, method="lfvt")   # on the GPU
    result.pairs, result.stats, result.plan

The port imports torch and numpy, never jax, and nothing of ``repro``.
Everything re-exported here resolves lazily (PEP 562), so ``import
repro_torch`` stays cheap until a symbol is touched.
"""
from __future__ import annotations

import importlib

_EXPORTS = {
    "join": "repro_torch.api",
    "JoinResult": "repro_torch.api",
    "as_collection": "repro_torch.api",
    "JoinPlan": "repro_torch.core.planner",
    "JoinStats": "repro_torch.core.planner",
    "PlannerError": "repro_torch.core.planner",
    "build_plan": "repro_torch.core.planner",
    "probe_features": "repro_torch.core.planner",
    "SetCollection": "repro_torch.core.sets",
    "cf_rs_join_device": "repro_torch.core.tile_join",
    "global_config": "repro_torch.core.config",
    "NotPortedError": "repro_torch.errors",
    "DeviceUnavailableError": "repro_torch.errors",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")
    val = getattr(importlib.import_module(mod), name)
    globals()[name] = val  # cache: next access skips the import machinery
    return val


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
