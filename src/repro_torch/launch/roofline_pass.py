"""Roofline pass: a step's per-card FLOPs, bytes and collective bytes
from two shallow clones of each architecture, extrapolated in depth.

The port of the JAX package's ``launch/roofline_pass.py``. Counting a
full-depth step op by op on the host is slow (``launch/dryrun.py``), so
this pass counts two shallow clones of each architecture (2 and 3 layers
for uniform stacks; 1 and 2 pattern periods for xLSTM and
RecurrentGemma) at ``microbatches=1`` and extrapolates linearly in
depth:

    cost(N) = cost(d_small) + (N - d_small) * (cost(d_big) - cost(d_small))
                                              / (d_big - d_small)

which is exact for homogeneous stacks.

The reference adds closed forms for the sLSTM token scans and the mLSTM
chunk scans, because XLA's cost analysis counts a loop body once. The
dry run counts every op that runs, every trip of every loop included, so
those corrections are 0 here (``corrections`` reports them as such);
adding the closed forms as well would count those loops twice. The one
correction kept is the reference's microbatch re-reads: a deployed train
step at ``mb`` microbatches reads the params ``mb - 1`` more times than
the clone's single microbatch, (mb - 1) x the bf16 param bytes on the
memory term.

Results land in ``results/torch_roofline/<arch>__<shape>__roofline.json``
(16 x 16 ``meta`` mesh)::

  PYTHONPATH=src python -m repro_torch.launch.roofline_pass \\
      --arch qwen2-1.5b --shape decode_32k
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

from ..configs import get_config
from ..configs.base import SHAPES
from ..models.transformer import build
from . import dryrun as dr
from .analysis import _param_count, model_bytes, model_flops, roofline
from .mesh import make_production_mesh

__all__ = ["analyse_cell", "RESULTS_DIR", "main"]

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "torch_roofline")
KEYS = ("flops", "bytes", "coll")


def _depths(cfg) -> tuple[int, int, float]:
    """(small, big, n_units) for depth extrapolation."""
    if cfg.pattern is None:
        return 2, 3, float(cfg.n_layers)
    p = len(cfg.pattern)
    return p, 2 * p, float(cfg.n_layers)


def _clone(cfg, depth: int, shape):
    over = dict(n_layers=depth, scan_layers=False, unroll_attn=True)
    if shape.kind == "train":
        over["remat"] = "full"
    return dataclasses.replace(cfg, **over)


def _raw_cost(arch, shape_name, cfg, mesh, batch, seq_len) -> dict:
    """A clone's per-card counts from the dry run at one microbatch."""
    res = dr.lower_cell(arch, shape_name, cfg=cfg, mesh=mesh, batch=batch,
                        seq_len=seq_len, microbatches=1,
                        remat=cfg.remat)
    return {"flops": float(res["cost"]["flops"]),
            "bytes": float(res["cost"]["bytes"]),
            "coll": float(res["collectives"]["total"]),
            "coll_by_kind": {k: float(v) for k, v in
                             res["collectives"].items() if k != "total"}}


def analyse_cell(arch: str, shape_name: str, *, cfg=None, mesh=None,
                 batch: int | None = None,
                 seq_len: int | None = None) -> dict:
    """One cell's depth-extrapolated roofline. ``cfg``, ``mesh``,
    ``batch`` and ``seq_len`` replace the arch's config, the 16 x 16
    ``meta`` mesh and the shape's batch and length."""
    shape = SHAPES[shape_name]
    cfg = cfg or get_config(arch)
    mesh = mesh or make_production_mesh(device="meta")
    chips = mesh.size
    d_small, d_big, n_units = _depths(cfg)
    t0 = time.time()
    c_small = _raw_cost(arch, shape_name, _clone(cfg, d_small, shape), mesh,
                        batch, seq_len)
    c_big = _raw_cost(arch, shape_name, _clone(cfg, d_big, shape), mesh,
                      batch, seq_len)
    per_unit = {k: (c_big[k] - c_small[k]) / (d_big - d_small)
                for k in KEYS}
    total = {k: c_small[k] + (n_units - d_small) * per_unit[k] for k in KEYS}
    corr = {"flops": 0.0, "bytes": 0.0}
    # microbatch param re-reads (a deployed train step accumulates)
    mb = dr.default_microbatches(cfg, shape)
    if mb > 1:
        total["bytes"] += (mb - 1) * 2.0 * _param_count(cfg, False) / chips
    shape_eff = dataclasses.replace(shape, global_batch=batch or
                                    shape.global_batch,
                                    seq_len=seq_len or shape.seq_len)
    mf = model_flops(cfg, shape_eff, per_device_chips=chips)
    model = build(cfg, tp=mesh.shape.get("model", 1))
    mbf = model_bytes(cfg, shape_eff, model, per_device_chips=chips)
    rf = roofline(total["flops"], total["bytes"], total["coll"], mf, mbf)
    return {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(str(s) for s in mesh.sizes),
        "method": f"depth-extrapolated ({d_small}->{d_big} layers)",
        "microbatches": mb,
        "analysis_s": round(time.time() - t0, 1),
        "per_layer": per_unit,
        "totals": total,
        "corrections": corr,
        "roofline": rf.to_dict(),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out-dir", default=RESULTS_DIR)
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    todo = list(dr.cells(False)) if args.all else [(args.arch, args.shape)]
    failures = 0
    for arch, shape_name in todo:
        tag = f"{arch}__{shape_name}__roofline"
        out_path = os.path.join(args.out_dir, tag + ".json")
        if os.path.exists(out_path):
            print(f"[skip] {tag}")
            continue
        print(f"[roofline] {tag} ...", flush=True)
        try:
            res = analyse_cell(arch, shape_name)
            with open(out_path, "w") as f:
                json.dump(res, f, indent=1)
            r = res["roofline"]
            print(f"  dominant={r['dominant']} "
                  f"frac={r['roofline_fraction']:.3f} "
                  f"useful={r['useful_flops_ratio']:.3f} "
                  f"terms=({r['compute_s']:.2e},{r['memory_s']:.2e},"
                  f"{r['collective_s']:.2e})s", flush=True)
        except Exception:
            failures += 1
            print(f"  FAILED {tag}\n{traceback.format_exc()}", flush=True)
    print(f"done; {failures} failures")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
