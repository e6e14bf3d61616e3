"""PyTorch/CUDA port of the candidate-free R-S set similarity join.

The public surface mirrors the JAX package's front door::

    import repro_torch
    result = repro_torch.join(R, S, 0.8)   # on the GPU, method="auto"
    result.pairs, result.stats, result.plan
    repro_torch.join(R, S, 0.8, n_shards=8)   # MR-CF-RS-Join, 8 shards
    repro_torch.join(R, S, 0.8, mesh=repro_torch.make_host_mesh(8))

    # spans and counters on the join path (off unless recording)
    with repro_torch.trace.recording() as rec:
        repro_torch.join(R, S, 0.8)
    rec.spans, rec.counters

    engine = repro_torch.DedupServeEngine(corpus, threshold=0.8)
    rid = engine.submit([3, 17, 4096])   # then engine.drain() / step()

    from repro_torch.models.params import init_params
    cfg = dataclasses.replace(repro_torch.get_config("qwen2-1.5b"),
                              attn_impl="flash")
    model = repro_torch.build_model(cfg)          # any of the 10 archs
    params = init_params(model.param_specs(), torch.Generator(device="cuda"))
    tokens = repro_torch.ServeEngine(model, params).generate(prompts, 32)

    # training (attn_impl="jnp": the flash kernel K7 has no backward)
    state = repro_torch.init_train_state(model, torch.Generator("cuda"))
    step = repro_torch.make_train_step(model, repro_torch.AdamWConfig())
    stream = repro_torch.TokenStream(cfg.vocab_size, batch=8, seq_len=512)
    state, metrics, _ = repro_torch.Trainer(step, stream.batch_at).run(
        state, 0, 10)

    # sharded: tensor parallelism over 2 model slots (here on one card)
    mesh = repro_torch.make_host_mesh(1, model=2)
    par = repro_torch.build_model(cfg, tp=2, mesh=mesh)
    tokens = repro_torch.ServeEngine(par, par.place(params)).generate(
        prompts, 32)

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
    "Mesh": "repro_torch.launch.mesh",
    "make_host_mesh": "repro_torch.launch.mesh",
    "make_production_mesh": "repro_torch.launch.mesh",
    "Rules": "repro_torch.sharding.rules",
    "Sharded": "repro_torch.sharding.placed",
    "ServeEngine": "repro_torch.serve.engine",
    "make_frontend_stub": "repro_torch.models.frontend",
    "build_model": "repro_torch.models.transformer",
    "get_config": "repro_torch.configs",
    "NotPortedError": "repro_torch.errors",
    "DeviceUnavailableError": "repro_torch.errors",
    "MeshTypeError": "repro_torch.errors",
    "NoBackwardError": "repro_torch.errors",
    "TokenStream": "repro_torch.data.synth",
    "Trainer": "repro_torch.train.trainer",
    "make_train_step": "repro_torch.train.trainer",
    "init_train_state": "repro_torch.train.trainer",
    "CheckpointManager": "repro_torch.train.checkpoint",
    "AdamWConfig": "repro_torch.train.optimizer",
}

__all__ = sorted(_EXPORTS)


#: exports whose name differs from the attribute they resolve to
_RENAMED = {"build_model": "build"}
#: submodules reached as attributes
_SUBMODULES = ("trace",)


def __getattr__(name: str):
    if name in _SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")
    val = getattr(importlib.import_module(mod), _RENAMED.get(name, name))
    globals()[name] = val  # cache: next access skips the import machinery
    return val


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
