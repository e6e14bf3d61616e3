"""PyTorch port vs JAX package: ``launch/`` (analysis, the ``meta``-device
dry run, the roofline pass), on the CPU.

- ``_param_count``, ``model_flops`` and ``model_bytes`` exactly equal to
  the reference's (``repro.launch.analysis``) for all 10 archs x 4
  shapes; the roofline's terms on the H100's peaks;
- the matmul FLOPs ``Counting`` reads from a dense smoke forward equal to
  their closed form, exactly;
- the roofline pass's depth-extrapolated counts (FLOPs, bytes,
  collective bytes) equal to the dry run's count of the full depth, at
  smoke configs grown to 5, 6 and 9 layers (a uniform stack, xLSTM's and
  RecurrentGemma's patterns), within 1e-12 (the extrapolation divides by
  the pattern's period);
- the dry run's argument bytes per slot (params, ZeRO-1 master/m/v and
  step, batch, decode state and position) equal to the reference's
  per-device bytes (``sharding.shard_shape`` of ``abstract_params``,
  ``zero1_shardings`` and ``dryrun.abstract_decode_state``) on a
  (pod, data, model) = (2, 2, 4) mesh, for granite-3-8b, qwen2-moe,
  recurrentgemma-2b and xlstm-350m smoke configs, every slot, exactly.
  The reference side runs in a subprocess with 16 forced host devices
  and ``AxisType.Auto`` axes (as ``test_torch_mesh.py``), compiling
  nothing (``eval_shape`` and ``shard_shape`` only);
- a dry-run cell's report: the reference's keys, and its argument bytes.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_get_config
from repro.configs.base import SHAPES as REF_SHAPES
from repro.launch import analysis as ref_analysis
from repro.models.transformer import build as ref_build
from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES
from repro_torch.launch import analysis, dryrun, roofline_pass
from repro_torch.launch.mesh import Mesh
from repro_torch.models.params import init_params
from repro_torch.models.transformer import build

ROOT = pathlib.Path(__file__).resolve().parent.parent
ARG_ARCHS = ("granite-3-8b", "qwen2-moe-a2.7b", "recurrentgemma-2b",
             "xlstm-350m")
B, L = 8, 32


def meta_mesh(sizes, names):
    n = 1
    for s in sizes:
        n *= s
    return Mesh(("meta",) * n, names, sizes)


@pytest.mark.parametrize("name", REF_ARCHS)
def test_analysis_matches_reference(name):
    ref_cfg, cfg = ref_get_config(name), get_config(name)
    rm, pm = ref_build(ref_cfg, 16), build(cfg, 16)
    for active in (False, True):
        assert analysis._param_count(cfg, active) == \
            ref_analysis._param_count(ref_cfg, active)
    for shape_name, shape in SHAPES.items():
        rs = REF_SHAPES[shape_name]
        assert analysis.model_flops(cfg, shape, 256) == \
            ref_analysis.model_flops(ref_cfg, rs, 256)
        assert analysis.model_bytes(cfg, shape, pm, 256) == \
            ref_analysis.model_bytes(ref_cfg, rs, rm, 256)
    rf = analysis.roofline(989e12, 3.35e12, 450e9, 989e12 / 2)
    assert (rf.compute_s, rf.memory_s, rf.collective_s) == (1.0, 1.0, 1.0)
    assert rf.roofline_fraction == 0.5 and rf.useful_flops_ratio == 0.5


def test_counted_matmul_flops_match_closed_form():
    cfg = get_config("granite-3-8b", smoke=True)
    model = build(cfg)
    params = init_params(model.param_specs(), torch.Generator().manual_seed(0),
                         torch.float32, "cpu")
    b, length = 2, 16
    with torch.no_grad(), dryrun.Counting() as c:
        model.forward(params, torch.zeros((b, length), dtype=torch.long))
    d, h, kv, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                    cfg.resolved_head_dim)
    t = b * length
    layer = (2 * t * d * (h + 2 * kv) * hd + 2 * t * h * hd * d
             + 2 * 2 * b * h * length * length * hd + 3 * 2 * t * d * cfg.d_ff)
    assert c.flops == cfg.n_layers * layer + 2 * t * d * model.vocab_p
    assert c.bytes > 0 and c.peak > 0


@pytest.mark.parametrize("name,layers", [("granite-3-8b", 5),
                                         ("xlstm-350m", 6),
                                         ("recurrentgemma-2b", 9)])
def test_depth_extrapolation_equals_full_count(name, layers):
    cfg = dataclasses.replace(get_config(name, smoke=True), n_layers=layers)
    mesh = meta_mesh((2, 2), ("data", "model"))
    got = roofline_pass.analyse_cell(name, "prefill_32k", cfg=cfg, mesh=mesh,
                                     batch=4, seq_len=16)
    assert got["corrections"] == {"flops": 0.0, "bytes": 0.0}
    full = dryrun.lower_cell(name, "prefill_32k", cfg=roofline_pass._clone(
        cfg, layers, SHAPES["prefill_32k"]), mesh=mesh, batch=4, seq_len=16)
    want = {"flops": full["cost"]["flops"], "bytes": full["cost"]["bytes"],
            "coll": full["collectives"]["total"]}
    for k in ("flops", "bytes", "coll"):
        assert want[k] > 0
        assert got["totals"][k] == pytest.approx(want[k], rel=1e-12), k


_SCRIPT = r"""
import os, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=16"
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType, NamedSharding
jax.devices()
from repro.configs import get_config
from repro.launch import dryrun as dr
from repro.models.params import abstract_params
from repro.models.transformer import build
from repro.sharding.rules import Rules, logical_to_spec
from repro.train.optimizer import adamw_init, zero1_shardings

mesh = jax.make_mesh((2, 2, 4), ("pod", "data", "model"),
                     axis_types=(AxisType.Auto,) * 3)
rules = Rules.default()
B, L = {b}, {l}

def nbytes(tree):
    return int(sum(np.prod(x.sharding.shard_shape(x.shape))
                   * np.dtype(x.dtype).itemsize
                   for x in jax.tree.leaves(tree)))

def batch(shape, dtype):
    spec = logical_to_spec(mesh, rules, ("batch",) + (None,) * (
        len(shape) - 1), shape)
    return jax.ShapeDtypeStruct(shape, dtype,
                                sharding=NamedSharding(mesh, spec))

out = {{}}
for arch in {archs!r}:
    cfg = get_config(arch, smoke=True)
    model = build(cfg, tp=4)
    pabs = abstract_params(model.param_specs(), mesh, rules)
    opt = jax.eval_shape(adamw_init, pabs)
    zsh = zero1_shardings(pabs, mesh)
    opt = jax.tree.map(lambda s, sh: jax.ShapeDtypeStruct(
        s.shape, s.dtype, sharding=sh), opt, zsh)
    state = dr.abstract_decode_state(model, B, L, mesh, rules)
    out[arch] = {{
        "params": nbytes(pabs), "opt": nbytes(opt),
        "train_batch": 2 * nbytes(batch((B, L), jnp.int32)),
        "prefill_batch": nbytes(batch((B, L), jnp.int32)),
        "decode_batch": nbytes(batch((B, 1), jnp.int32)),
        "state": nbytes(state) + 4}}
print("ARGS " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_bytes():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT.format(b=B, l=L, archs=ARG_ARCHS)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [x for x in proc.stdout.splitlines() if x.startswith("ARGS ")]
    return json.loads(line[-1][5:])


@pytest.mark.parametrize("name", ARG_ARCHS)
def test_argument_bytes_match_reference(name, reference_bytes):
    want = reference_bytes[name]
    mesh = meta_mesh((2, 2, 4), ("pod", "data", "model"))
    model = build(get_config(name, smoke=True), 4, mesh=mesh)
    for slot in range(mesh.size):
        got = {k: dryrun.argument_bytes(model, k, B, L, slot)
               for k in ("train_4k", "prefill_32k", "decode_32k")}
        assert got["train_4k"]["params"] == want["params"]
        assert got["train_4k"]["opt"] == want["opt"]
        assert got["train_4k"]["batch"] == want["train_batch"]
        assert got["prefill_32k"]["batch"] == want["prefill_batch"]
        assert got["decode_32k"]["batch"] == want["decode_batch"]
        assert got["decode_32k"]["state"] == want["state"], slot


def test_dry_run_cell_report():
    mesh = meta_mesh((2, 2, 4), ("pod", "data", "model"))
    cfg = get_config("granite-3-8b", smoke=True)
    res = dryrun.lower_cell("granite-3-8b", "decode_32k", cfg=cfg, mesh=mesh,
                            batch=B, seq_len=L)
    model = build(cfg, 4, mesh=mesh)
    args = dryrun.argument_bytes(model, "decode_32k", B, L)
    assert res["memory"]["argument_bytes"] == sum(args.values())
    assert res["chips"] == 16 and res["slots_counted"] == 4
    assert set(res) >= {"memory", "cost", "collectives", "collective_counts",
                        "roofline"}
    assert res["collective_counts"]["all-reduce"] > 0
    r = res["roofline"]
    assert r["compute_s"] == res["cost"]["flops"] / analysis.PEAK_FLOPS
    assert r["memory_s"] == res["cost"]["bytes"] / analysis.HBM_BW
    assert r["collective_s"] == res["collectives"]["total"] / analysis.LINK_BW
