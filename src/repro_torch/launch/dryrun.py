"""Dry run on the ``meta`` device: what one card of a production mesh
holds and does for a step of every (arch x shape) cell.

The port of the JAX package's ``launch/dryrun.py``, with no compiler to
ask: per cell it

  1. builds the model at ``tp`` = the mesh's ``model`` size on
     ``make_production_mesh(device="meta")`` (16 x 16, or 2 x 16 x 16
     with ``--multi-pod``), with the config's ``attn_impl`` (``"jnp"``:
     K7 has no ``meta`` form), and the abstract params, the ZeRO-1
     optimizer pieces, the batch and the decode state as ``meta`` pieces
     with their placements; nothing is allocated;
  2. runs the train step, the prefill or the decode step on them under
     ``Counting``, a dispatch mode that sums each op's FLOPs
     (``torch.utils.flop_counter``), its operand and result bytes (what
     XLA's "bytes accessed" sums) and the high-water mark of the bytes
     the step allocates and still holds, with
     ``collectives.separate_slots()`` (each slot does its own work) and
     ``collectives.counter`` for the collectives;
  3. reports the reference's keys, per card: ``memory`` (argument
     bytes, exact: one slot's pieces; output and temp bytes, the peak
     estimate), ``cost`` (flops, bytes), ``collectives`` and
     ``collective_counts``, and ``roofline`` on the H100's peaks
     (``launch/analysis.py``).

The per-card figures are the slots' totals over the slots that ran. A
serve step runs one ``(pod, data)`` group's slots (every group does the
same work), an MoE model's every group (they run in lockstep, one
routing over the batch); a train step runs every slot (its reduction
spans the groups). The temp figure is the group's high-water mark over
its slots, which live side by side here, so it counts every slot's
activations at once: a card's own peak is at most that.

Results land in ``results/torch_dryrun/<arch>__<shape>__<mesh>.json``::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b \\
      --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

A train cell at full depth runs every slot's microbatches op by op, so
it takes minutes to hours on the host; ``launch/roofline_pass.py`` costs
two shallow clones instead.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from ..configs import ALIASES, get_config
from ..configs.base import SHAPES
from ..models.parallel import lockstep
from ..models.params import abstract_params, tree_leaves
from ..models.transformer import build
from ..sharding import collectives as coll
from ..sharding.rules import Placement, logical_to_spec
from ..train.optimizer import AdamWConfig, zero1_shardings
from ..train.parallel import place_train_state
from ..train.trainer import make_train_step
from .analysis import model_bytes, model_flops, roofline
from .mesh import make_production_mesh

__all__ = ["Counting", "lower_cell", "argument_bytes", "cells",
           "default_microbatches", "LONG_OK", "RESULTS_DIR", "main"]

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "torch_dryrun")

# long_500k runs only for sub-quadratic archs (as the reference's)
LONG_OK = {"starcoder2-3b", "xlstm-350m", "recurrentgemma-2b"}


def default_microbatches(cfg, shape) -> int:
    """The reference's gradient accumulation of a train cell (16)."""
    return 16 if shape.kind == "train" else 1


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Counting(TorchDispatchMode):
    """Per op: FLOPs (``flops``, by ``torch.utils.flop_counter``'s
    formulas, through an inner ``FlopCounterMode``), the bytes of its
    tensor operands and results (``bytes``; views move nothing and are
    not counted), and the bytes of the storages it makes (results that
    alias no operand) while any tensor still holds them: ``live`` now,
    ``peak`` its high-water mark."""

    def __init__(self):
        super().__init__()
        self.flop_mode = FlopCounterMode(display=False)
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._held: dict = {}     # storage key -> (storage, bytes)

    def __enter__(self):
        self.flop_mode.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self.flop_mode.__exit__(*exc)
        return out

    @property
    def flops(self) -> int:
        return self.flop_mode.get_total_flops()

    def _purge(self) -> None:
        """Drop the storages no tensor holds any more (only this mode's
        reference is left)."""
        for key, (st, n) in list(self._held.items()):
            if torch._C._storage_Use_Count(st._cdata) <= 1:
                del self._held[key]
                self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view:
            return out
        ins = [x for x in tree_flatten((args, kwargs or {}))[0]
               if isinstance(x, torch.Tensor)]
        outs = out if isinstance(out, (tuple, list)) else (out,)
        self.bytes += sum(_nbytes(x) for x in ins)
        rets = func._schema.returns
        for i, x in enumerate(outs):
            if not isinstance(x, torch.Tensor):
                continue
            self.bytes += _nbytes(x)
            if i < len(rets) and rets[i].alias_info is not None:
                continue       # in place: the operand's storage
            st = x.untyped_storage()
            if st._cdata in self._held:
                continue
            n = st.nbytes()
            self._held[st._cdata] = (st, n)
            self.live += n
            if self.live > self.peak:
                self._purge()
                self.peak = max(self.peak, self.live)
        return out


def _placed_bytes(tree, slot: int) -> int:
    """Bytes of ``slot``'s pieces of a tree of ``Sharded``."""
    return sum(_nbytes(x.shards[slot]) for x in tree_leaves(tree))


def _batch_bytes(mesh, rules, shape, dtype) -> int:
    """The bytes of a slot's piece of a batch tensor of global ``shape``
    cut on ``batch``."""
    spec = logical_to_spec(mesh, rules, ("batch",) + (None,) * (
        len(shape) - 1), shape)
    local = Placement(mesh, spec).local_shape(shape)
    return math.prod(local) * torch.empty((), dtype=dtype).element_size()


def argument_bytes(model, shape_name: str, batch: int | None = None,
                   seq_len: int | None = None, slot: int = 0) -> dict:
    """The bytes of ``slot``'s pieces of a cell's arguments, by kind:
    ``params`` (bf16), ``opt`` (ZeRO-1's float32 master, m and v, and the
    int32 step; train), ``batch`` (the int32 tokens, and labels for
    train; the bf16 stub embeddings of a vision model), ``state`` (the
    decode state's pieces and the int32 position; decode)."""
    shape = SHAPES[shape_name]
    mesh, cfg, rules = model.mesh, model.cfg, model.rules
    b = batch or shape.global_batch
    length = seq_len or shape.seq_len
    n_front = cfg.n_frontend_tokens if cfg.frontend == "vision" else 0
    pabs = abstract_params(model.param_specs(), mesh, rules)
    out = {"params": _placed_bytes(pabs, slot), "opt": 0, "batch": 0,
           "state": 0}
    shapes = {"train": [((b, length - n_front), torch.int32)] * 2,
              "prefill": [((b, length - n_front), torch.int32)],
              "decode": [((b, 1), torch.int32)]}[shape.kind]
    if n_front and shape.kind != "decode":
        shapes.append(((b, n_front, cfg.d_model), torch.bfloat16))
    out["batch"] = sum(_batch_bytes(mesh, rules, s, dt) for s, dt in shapes)
    if shape.kind == "train":
        zero = zero1_shardings(pabs, mesh)
        for key in ("master", "m", "v"):
            out["opt"] += sum(
                4 * math.prod(z.local_shape(x.shape))
                for z, x in zip(tree_leaves(zero[key]), tree_leaves(pabs)))
        out["opt"] += 4
    elif shape.kind == "decode":
        grp = next(g for g in mesh.groups(("model",)) if slot in g)
        rows = model.plan.rows_of(b)[mesh.groups(("model",)).index(grp)]
        n = len(range(b)[rows])
        st = model.init_decode_state(n, length, torch.bfloat16, "meta",
                                     slot=grp.index(slot))
        out["state"] = sum(_nbytes(x) for x in tree_leaves(st)) + 4
    return out


def _tensors(tree):
    """Every tensor in nested dicts, lists, tuples and ``Sharded``s."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif hasattr(tree, "shards"):
        yield from _tensors(tree.shards)


def _run_serve(model, kind, b, length, n_front):
    """One prefill or decode step of the first run (``lockstep``) ->
    (the ``Counting`` of it, its slots, the step's results)."""
    cfg, mesh = model.cfg, model.mesh
    placed = abstract_params(model.param_specs(), mesh, model.rules)
    groups = model.slot_groups(placed, b)
    run = lockstep(model.cfg, groups)[0]
    extra = (torch.empty((b, n_front, cfg.d_model), dtype=torch.bfloat16,
                         device="meta") if n_front else None)
    if kind == "prefill":
        toks = torch.empty((b, length - n_front), dtype=torch.int32,
                           device="meta")
        pos = None
    else:
        toks = torch.empty((b, 1), dtype=torch.int32, device="meta")
        extra, pos = None, length - 1

    def states():
        return [[model.init_decode_state(len(range(b)[g.rows]), length,
                                         torch.bfloat16, "meta", slot=k)
                 for k in range(len(g.devs))] for g in run]
    # a prefill makes its decode state (part of its result); a decode
    # step takes it as an argument and writes it in place
    given = states() if kind == "decode" else None
    with torch.no_grad(), Counting() as c, coll.separate_slots():
        st = given or states()
        out = model.run_groups(run, toks, extra, states=st, pos=pos), st
    return c, sum(len(g.slots) for g in run), out


def _run_train(model, b, length, n_front, mb):
    mesh, cfg = model.mesh, model.cfg
    placed = abstract_params(model.param_specs(), mesh, model.rules)
    state = place_train_state(model, params=placed)
    batch = {"tokens": torch.empty((b, length - n_front), dtype=torch.int32,
                                   device="meta")}
    batch["labels"] = torch.empty_like(batch["tokens"])
    if n_front:
        batch["extra_embeds"] = torch.empty(
            (b, n_front, cfg.d_model), dtype=torch.bfloat16, device="meta")
    step = make_train_step(model, AdamWConfig(), microbatches=mb)
    with Counting() as c, coll.separate_slots():
        out = step(state, batch)
    return c, mesh.size, out


def lower_cell(arch: str, shape_name: str, multi_pod: bool = False,
               microbatches: int | None = None, remat: str | None = None,
               *, cfg=None, mesh=None, batch: int | None = None,
               seq_len: int | None = None) -> dict:
    """The dry run of one cell (see the module docstring). ``cfg``,
    ``mesh``, ``batch`` and ``seq_len`` replace the arch's config, the
    production mesh and the shape's global batch and length (a smoke
    config on a small ``meta`` mesh)."""
    shape = SHAPES[shape_name]
    mesh = mesh or make_production_mesh(multi_pod=multi_pod, device="meta")
    cfg = cfg or get_config(arch)
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat=remat)
    elif shape.kind == "train":
        cfg = dataclasses.replace(cfg, remat="full")
    model = build(cfg, tp=mesh.shape.get("model", 1), mesh=mesh)
    mb = (microbatches if microbatches is not None
          else default_microbatches(cfg, shape))
    b = batch or shape.global_batch
    length = seq_len or shape.seq_len
    n_front = cfg.n_frontend_tokens if cfg.frontend == "vision" else 0
    args = argument_bytes(model, shape_name, b, length)
    coll.counter.reset()
    t0 = time.time()
    if shape.kind == "train":
        c, slots, out = _run_train(model, b, length, n_front, mb)
    else:
        c, slots, out = _run_serve(model, shape.kind, b, length, n_front)
    run_s = time.time() - t0
    snap = coll.counter.snapshot()
    out_bytes = 0
    seen: set = set()
    for x in _tensors(out):
        key = x.untyped_storage()._cdata
        if key in c._held and key not in seen:
            seen.add(key)
            out_bytes += x.untyped_storage().nbytes()
    del out
    chips = mesh.size
    arg = sum(args.values())
    output = out_bytes // slots
    temp = max(c.peak // slots - output, 0)
    flops = c.flops / slots
    nbytes = c.bytes / slots
    coll_bytes = snap["total"] / slots
    shape_eff = dataclasses.replace(shape, global_batch=b, seq_len=length)
    rf = roofline(flops, nbytes, coll_bytes,
                  model_flops(cfg, shape_eff, per_device_chips=chips),
                  model_bytes(cfg, shape_eff, model, per_device_chips=chips))
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": "x".join(str(s) for s in mesh.sizes),
        "chips": chips,
        "slots_counted": slots,
        "microbatches": mb,
        "run_s": round(run_s, 2),
        "memory": {
            "argument_bytes": arg,
            "argument_bytes_by_kind": args,
            "output_bytes": output,
            "temp_bytes": temp,
            "alias_bytes": 0,
            "peak_hbm_estimate": arg + temp + output,
        },
        "cost": {"flops": flops, "bytes": nbytes},
        "collectives": {k: v / slots for k, v in snap["bytes"].items()}
        | {"total": coll_bytes},
        "collective_counts": snap["calls"],
        "roofline": rf.to_dict(),
    }


def cells(multi_pod: bool = False):
    for arch in ALIASES:
        for shape_name in SHAPES:
            if shape_name == "long_500k" and arch not in LONG_OK:
                continue
            yield arch, shape_name


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--microbatches", type=int)
    ap.add_argument("--remat")
    ap.add_argument("--out-dir", default=RESULTS_DIR)
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    todo = (list(cells(args.multi_pod)) if args.all
            else [(args.arch, args.shape)])
    failures = 0
    for arch, shape_name in todo:
        mesh_tag = "2x16x16" if args.multi_pod else "16x16"
        tag = f"{arch}__{shape_name}__{mesh_tag}"
        out_path = os.path.join(args.out_dir, tag + ".json")
        if os.path.exists(out_path):
            print(f"[skip] {tag} (cached)")
            continue
        print(f"[cell] {tag} ...", flush=True)
        try:
            res = lower_cell(arch, shape_name, args.multi_pod,
                             microbatches=args.microbatches,
                             remat=args.remat)
            with open(out_path, "w") as f:
                json.dump(res, f, indent=1)
            r = res["roofline"]
            print(f"  ok run={res['run_s']}s dominant={r['dominant']} "
                  f"frac={r['roofline_fraction']:.3f} "
                  f"hbm={res['memory']['peak_hbm_estimate'] / 2**30:.2f}GiB",
                  flush=True)
        except Exception:
            failures += 1
            print(f"  FAILED {tag}\n{traceback.format_exc()}", flush=True)
    print(f"done; {failures} failures")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
