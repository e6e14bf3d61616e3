"""Run one cell of the port's benchmark once, and print its result line.

    python3 portbench/run.py --workload livej.lfvt --seed 7 --seconds 30 \
        --trace 0

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration (``configs/<name>.json``: the resident corpus S and the R
pool, made from the seed by ``data.py``, and the join's measure,
threshold, ``emit`` and ``r_block``) and a traffic mix
(``traffic/<name>.json``: a closed loop of one caller, and under ``join``
the further keyword arguments of ``repro_torch.join``, such as
``method``, passed through as they are). One run:

1. set-up: makes S and the R pool on the card from the seed, hands S to
   the program as a ``SetCollection`` and runs two ops, the first of
   which stages S on the card (``first_op_s``);
2. the window: one caller, a closed loop. Each op draws ``r_batch`` rows of
   the pool without replacement (a seeded stream), builds a new
   ``SetCollection`` of them and calls ``repro_torch.join(R, S, t, ...)``,
   which returns with the pairs on the host. Ops start until ``--seconds``
   have passed; the window ends with the last op;
3. ``--trace 1`` records the window with the profiler and reads the
   cell's per-layer metrics (``metrics/<name>.py``) from it; ``--trace 0``
   reports the end-to-end metrics;
4. the check, once the program's state is freed: a seeded sample of the
   window's ops is joined again by the plain reference (``reference.py``)
   and every pair compared.

The last line of standard output is the result's JSON object; the numbers
compared, each beside its limit, are the last lines of standard error.
The run needs a CUDA device and exits with code 2 (and no result)
without one, 3 if a module of JAX or of the JAX package ``repro`` was
loaded, and 4 if the cell is unknown.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
#: top-level module names that no run may load (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: ops of the window that the reference joins again
CHECK_OPS = 8
#: warm-up ops at set-up; the first stages S
WARM_OPS = 2
#: the keys a traffic mix may hold: those the harness reads, and its why
TRAFFIC_KEYS = {"loop", "clients", "op", "join", "why"}
#: ``repro_torch.join``'s arguments that the configuration or the
#: harness set, so that a traffic mix's ``join`` may not
FIXED_JOIN_ARGS = {"measure", "emit", "r_block", "device", "stats"}


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def cell_parts(bench: dict, workload: str, root: Path = ROOT):
    """-> (cell, configuration, traffic) of ``workload``; KeyError when
    the benchmark has no such cell."""
    cell = next((w for w in bench["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        raise KeyError(workload)
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = load_json(root / conf["file"])
    traffic = load_json(root / "portbench" / "traffic"
                        / f"{cell['traffic']}.json")
    return cell, cfg, traffic


def join_args(traffic: dict, cfg: dict) -> dict:
    """The keyword arguments of each op's ``repro_torch.join``: the
    configuration's measure, ``emit`` and ``r_block``, and the traffic
    mix's ``join`` dict passed through. ValueError for a mix that the
    harness cannot run as it says: a key it does not read, a loop other
    than a closed one of one caller, an op other than ``join``, or a
    ``join`` argument that the configuration sets."""
    unread = set(traffic) - TRAFFIC_KEYS
    if unread:
        raise ValueError(f"traffic keys the harness does not read: "
                         f"{sorted(unread)}")
    if (traffic.get("op") != "join" or traffic.get("loop") != "closed"
            or traffic.get("clients") != 1):
        raise ValueError("only a closed loop of joins by one caller is "
                         "generated")
    extra = dict(traffic.get("join", {}))
    clash = set(extra) & FIXED_JOIN_ARGS
    if clash:
        raise ValueError(f"join arguments set by the configuration or the "
                         f"harness: {sorted(clash)}")
    return {"measure": cfg["measure"], "emit": cfg["emit"],
            "r_block": cfg["r_block"], **extra}


def reader(name: str, root: Path = ROOT):
    """The per-layer metric ``name``'s reader, ``metrics/<name>.py``."""
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules(names=None) -> list:
    """The top-level names of ``FORBIDDEN`` among the modules ``names``
    (by default, those loaded), compared whole: ``repro_torch`` is not
    ``repro``."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             trace: bool, device, t0: float, make_join=None, sizes=None,
             root: Path = ROOT) -> dict:
    """One run of ``workload`` on ``device`` -> the result object.

    ``t0`` is when the process started. ``make_join(made, device)``, given
    the run's data, returns what stands in for ``repro_torch.join``: the
    control (``control.py``), or the timed path broken on purpose (the
    tests). ``sizes`` overrides keys of the configuration, such as
    ``s_sets`` and ``r_batch`` (the tests' runs on the CPU)."""
    import numpy as np
    import torch

    from portbench import data, yardstick
    from portbench.trace import WINDOW, record

    _, cfg, traffic = cell_parts(bench, workload, root)
    cfg = {**cfg, **(sizes or {})}
    kw = join_args(traffic, cfg)
    if str(root / "src") not in sys.path:
        sys.path.insert(0, str(root / "src"))
    import repro_torch
    from repro_torch.core.sets import SetCollection
    device = torch.device(device)
    universe, thr = cfg["universe"], cfg["threshold"]
    batch, n_pool = cfg["r_batch"], cfg["r_pool"]
    kw["device"] = device
    log = []

    t = time.perf_counter()
    made = data.make(cfg, seed, device)
    join = make_join(made, device) if make_join else repro_torch.join
    pool_sets = data.split(*made["pool"])
    S = SetCollection(data.split(*made["s"]), universe,
                      np.arange(cfg["s_sets"], dtype=np.int32))
    log.append(f"data_s={time.perf_counter() - t:.6f}")
    stream = np.random.default_rng(np.random.SeedSequence(
        [int(seed) % 2 ** 64, 1]))

    def draw():
        rows = stream.choice(n_pool, batch, replace=False)
        R = SetCollection([pool_sets[i] for i in rows], universe,
                          rows.astype(np.int32))
        return rows, R

    spans = {}
    for k in range(WARM_OPS):
        rows, R = draw()
        t = time.perf_counter()
        join(R, S, thr, **kw)
        spans["first_op_s" if k == 0 else f"warm_op_{k}_s"] = (
            time.perf_counter() - t)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()

    ops, failed = [], 0
    prof = record() if trace else None
    if prof is not None:
        prof.__enter__()
    t_start = time.perf_counter()
    setup_s = t_start - t0
    deadline = t_start + seconds
    with torch.profiler.record_function(WINDOW):
        while True:
            now = time.perf_counter()
            if now >= deadline and ops:
                break
            with torch.profiler.record_function("portbench.draw"):
                rows, R = draw()
            try:
                with torch.profiler.record_function("portbench.join"):
                    t = time.perf_counter()
                    res = join(R, S, thr, **kw)
                    dt = time.perf_counter() - t
            except Exception:  # an op that fails ends the window
                traceback.print_exc()
                failed += 1
                break
            ops.append({"rows": rows, "seconds": dt, "pairs": res.pairs,
                        "stats": res.stats})
    t_end = time.perf_counter()
    if prof is not None:
        prof.__exit__(None, None, None)
    window_s = t_end - t_start
    peak = 0
    if on_card:
        window_peak = torch.cuda.max_memory_allocated()
        peak = max(setup_peak, window_peak)
    # the program's state goes before the readers and the reference run
    del S, R
    res = None
    for op in ops:
        op["stats"] = dict(op["stats"])
        got = np.array(sorted(op["pairs"]), np.int64).reshape(-1, 2)
        op["pair_r"] = got[:, 0]
        op["pairs"] = set(map(tuple, got.tolist()))
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    seconds_all = [op["seconds"] for op in ops]
    log.append(f"setup_s={setup_s:.6f} " + " ".join(
        f"{k}={v:.6f}" for k, v in spans.items()))
    log.append("op_ms=" + ",".join(f"{1e3 * v:.1f}" for v in seconds_all))
    log.append(f"ops={len(ops)} failed={failed} window_s={window_s:.6f} "
               f"op_s_sum={sum(seconds_all):.6f} bench_share_of_window="
               f"{1 - sum(seconds_all) / window_s if ops else 0:.6f}")
    metrics = {}
    ctx = SimpleNamespace(
        trace=prof.trace if prof is not None else None, ops=ops, cfg=cfg,
        threshold=thr, pool=made["pool"], s=made["s"], spans=spans,
        device=device)
    units = {m["name"]: m["unit"] for m in bench["end_to_end"]
             + bench["per_layer"]}
    t = time.perf_counter()
    for m in bench["per_layer" if trace else "end_to_end"]:
        name = m["name"]
        if trace:
            value = reader(name, root)(ctx)
        elif not ops:
            value = None
        elif name == "r_sets_per_s":
            value = yardstick.rate(batch * len(ops), window_s)
        elif name == "join_p95_ms":
            value = 1e3 * yardstick.percentile(seconds_all, 95)
        elif name == "peak_mem_gb":
            value = window_peak / 1e9 if on_card else None
        elif name == "setup_s":
            value = setup_s
        else:
            raise KeyError(f"no end-to-end metric {name}")
        if value is not None:
            metrics[name] = {"value": value, "unit": units[name]}
    if trace:
        log.append(f"trace read_s={prof.read_s:.6f} chrome_trace_bytes="
                   f"{prof.export_bytes} readers_s="
                   f"{time.perf_counter() - t:.6f} device_events="
                   f"{len(prof.trace.device)} host_events="
                   f"{len(prof.trace.host)} host_samples="
                   f"{len(prof.trace.samples)} copy_bytes="
                   f"{json.dumps(prof.trace.copy_bytes)}")
    log.append(join_summary(ops))
    checks, line = check(ops, made, universe, thr, device, seed)
    log.append(line)
    correct = (bool(ops) and failed == 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": (torch.cuda.get_device_name(device) if on_card
                    else device.type),
           "count": 1, "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": len(ops) + failed,
           "failed": failed, "metrics": metrics, "device": dev}
    if prof is not None:
        dev["busy_s"] = prof.trace.busy_s
        dev["window_s"] = prof.trace.window_s
        out["breakdown"] = {"device_ops": prof.trace.top_device_ops(),
                            "idle_gaps": prof.trace.idle_gaps()}
    out["log"] = log
    out["checks"] = checks
    return out


def join_summary(ops) -> str:
    """The methods the ops ran and the sums of the program's counters."""
    methods = sorted({str(op["stats"].get("method")) for op in ops})
    sums = {k: sum(int(op["stats"].get(k, 0) or 0) for op in ops)
            for k in ("pair_count", "walk_steps", "early_stops",
                      "live_tiles", "total_tiles", "regrows",
                      "output_bytes", "r_rep_cache_hits")}
    return f"join methods={','.join(methods)} " + " ".join(
        f"{k}={v}" for k, v in sums.items())


def check(ops, made, universe, t, device, seed):
    """The check: a seeded sample of ``CHECK_OPS`` of the window's ops
    joined again by the reference, every pair compared -> (the numbers
    compared, each with its limit; a log line)."""
    import numpy as np

    from portbench import reference
    pick = np.random.default_rng(np.random.SeedSequence(
        [int(seed) % 2 ** 64, 2])).choice(
            len(ops), min(CHECK_OPS, len(ops)), replace=False)
    missing = extra = compared = 0
    t0 = time.perf_counter()
    for i in sorted(pick):
        op = ops[i]
        want = reference.pairs(made["pool"], op["rows"], made["s"], universe,
                               t, device)
        want = {(int(op["rows"][a]), b) for a, b in want}
        m, e = reference.compare(op["pairs"], want)
        missing, extra, compared = missing + m, extra + e, compared + len(
            want)
    line = (f"check ops={len(pick)} reference_pairs={compared} "
            f"missing={missing} extra={extra} "
            f"reference_s={time.perf_counter() - t0:.6f}")
    return {"missing_pairs": {"value": missing, "limit": 0},
            "extra_pairs": {"value": extra, "limit": 0}}, line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.chdir(ROOT)  # the planner calibrates from the checkout's root
    # every build and kernel cache inside the checkout, at fixed paths, so
    # that only a checkout's first run builds; set here because later PRs
    # that bring a Triton or extension kernel may not edit the harness
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ.setdefault(var, str(ROOT / "build" / sub))
    sys.path.insert(0, str(ROOT))
    import torch
    bench = load_json(ROOT / "BENCHMARK.json")
    try:
        cell = cell_parts(bench, args.workload)[0]
    except KeyError:
        print(f"no cell {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 4
    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell["chips"]):
        print(f"cell {args.workload} needs {cell['chips']} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = run_cell(bench, args.workload, args.seed, args.seconds,
                   bool(args.trace), "cuda", T0)
    bad = forbidden_modules()
    if bad:
        print(f"loaded modules of {', '.join(bad)}: the port must not load "
              "JAX or the JAX package", file=sys.stderr)
        return 3
    for line in out.pop("log"):
        print(f"[portbench {args.workload}] {line}")
    print(f"[portbench {args.workload}] card {card()}")
    print(json.dumps(out), flush=True)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
