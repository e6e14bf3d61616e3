"""PyTorch/CUDA port of the candidate-free R-S set similarity join.

The public surface mirrors the JAX package's front door::

    import repro_torch
    result = repro_torch.join(R, S, 0.8)   # on the GPU, method="auto"
    result.pairs, result.stats, result.plan
    repro_torch.join(R, S, 0.8, n_shards=8)   # MR-CF-RS-Join, 8 shards

    engine = repro_torch.DedupServeEngine(corpus, threshold=0.8)
    rid = engine.submit([3, 17, 4096])   # then engine.drain() / step()

    from repro_torch.models.params import init_params
    cfg = dataclasses.replace(repro_torch.get_config("qwen2-1.5b"),
                              attn_impl="flash")
    model = repro_torch.build_model(cfg)          # a dense transformer
    params = init_params(model.param_specs(), torch.Generator(device="cuda"))
    tokens = repro_torch.ServeEngine(model, params).generate(prompts, 32)

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
    "mr_cf_rs_join": "repro_torch.core.distributed",
    "shard_blocks": "repro_torch.core.distributed",
    "global_config": "repro_torch.core.config",
    "DedupServeEngine": "repro_torch.serve.dedup",
    "DedupResult": "repro_torch.serve.dedup",
    "IncrementalLFVT": "repro_torch.core.lfvt_flat",
    "DedupPipeline": "repro_torch.data.pipeline",
    "ServeEngine": "repro_torch.serve.engine",
    "build_model": "repro_torch.models.transformer",
    "get_config": "repro_torch.configs",
    "NotPortedError": "repro_torch.errors",
    "DeviceUnavailableError": "repro_torch.errors",
}

__all__ = sorted(_EXPORTS)


#: exports whose name differs from the attribute they resolve to
_RENAMED = {"build_model": "build"}


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")
    val = getattr(importlib.import_module(mod), _RENAMED.get(name, name))
    globals()[name] = val  # cache: next access skips the import machinery
    return val


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
