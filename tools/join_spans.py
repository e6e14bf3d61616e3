"""Run one cell of the port's benchmark with the program's spans recorded.

    python3 tools/join_spans.py --workload livej.lfvt --seed 7 --seconds 51

The run is ``portbench/run.py``'s traced run (its ``run_cell`` with the
profiler over the window, the same set-up, window and check) under
``repro_torch.trace.recording()``, from before set-up's first op to the
end. After the harness's log and result line it prints what the
program's spans say (arithmetic in ``portbench/spans.py``; ops from
``run.WARM_OPS`` on are the window's):

* ``plan_ms_per_op``, ``collection_ms_per_op``, ``driver_self_ms_per_op``
  (self times in the window, ms an op) and ``s_stage_s`` (the S staging
  spans of set-up's first op) beside ``first_op_s``;
* ``decomposition``: the mean window op by layer, ms; ``span_counts``:
  the window's spans by name (ops, blocks, builds, stagings);
  ``counters``: what the window added to each counter;
* ``idle_by_span``: the card's idle seconds in the window, each idle gap
  split over the innermost program spans open across it (top 10), and
  the share of idle time under a span other than the root
  ``repro_torch.join``;
* ``span_clock_slack_us``: the worst gap between an op's root span and
  the profiler's ``portbench.join`` range around the same call, with the
  quartiles of the gaps at the start and at the end;
* ``self_ms_per_op_by_span``: the window's self time by span name;
* coverage: the median share of an op that no inner span covers, and the
  window's root spans summed against the harness's ``op_s_sum``.

The last line is a JSON object of everything printed. Needs a CUDA
device. It reads the run's context through a stand-in per-layer reader,
until ``run.py`` hands a recording to its readers itself.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
#: the stand-in per-layer metric through which the run's context is read
CAPTURE = "join_spans_context"


def traced(bench, workload, seed, seconds) -> dict:
    """One traced harness run under ``recording()`` -> what it gave."""
    import repro_torch
    from repro_torch import trace

    from portbench import run, spans
    got: dict = {}
    read = run.reader

    def reader(name, root=run.ROOT):
        if name == CAPTURE:
            return lambda ctx: got.update(ctx=ctx)  # reports no value
        return read(name, root)

    def make_join(made, dev):
        calls = []

        def join(R, S, t, **kw):
            if len(calls) == run.WARM_OPS:
                got["before"] = dict(rec.counters)
            calls.append(1)
            return repro_torch.join(R, S, t, **kw)
        return join

    bench = dict(bench, per_layer=bench["per_layer"] + [
        {"name": CAPTURE, "unit": "-"}])
    run.reader = reader  # run_cell hands every reader the run's context
    try:
        with trace.recording() as rec:
            out = run.run_cell(bench, workload, seed, seconds, True, "cuda",
                               time.perf_counter(), make_join=make_join)
    finally:
        run.reader = read
    ctx, first = got["ctx"], run.WARM_OPS
    roots = spans.root_seconds(rec, first)
    op_s_sum = sum(op["seconds"] for op in ctx.ops)
    top, inner = spans.idle_by_span(rec, ctx.trace)
    gaps = spans.clock_gaps_us(rec, ctx.trace, first)
    prog = {
        "plan_ms_per_op": spans.plan_ms_per_op(rec, first),
        "collection_ms_per_op": spans.collection_ms_per_op(rec, first),
        "driver_self_ms_per_op": spans.driver_self_ms_per_op(rec, first),
        "s_stage_s": spans.s_stage_s(rec, 0),
        "first_op_s": ctx.spans.get("first_op_s"),
        "decomposition": spans.decomposition(rec, first),
        "span_counts": spans.span_counts(rec, first),
        "counters": spans.counters_between(got.get("before", {}),
                                           rec.counters),
        "idle_by_span": top,
        "idle_under_inner_span_pct": inner,
        "idle_s": ctx.trace.window_s - ctx.trace.busy_s,
        "span_clock_slack_us": spans.clock_slack_us(rec, ctx.trace, first),
        "span_clock_gaps_us": {"start": quartiles([a for a, _ in gaps]),
                               "end": quartiles([b for _, b in gaps])},
        "self_ms_per_op_by_span": dict(sorted(
            spans.self_ms_by_name(rec, first).items(), key=lambda kv: -kv[1])),
        "root_self_share_median": spans.root_self_share(rec, first),
        "root_s_sum": sum(roots), "op_s_sum": op_s_sum,
        "root_over_op_s_sum": sum(roots) / op_s_sum if op_s_sum else None,
        "window_ops": len(roots), "spans": len(rec.spans),
    }
    return {"result": out, "program": prog}


def quartiles(xs) -> list:
    """[min, Q1, median, Q3, max] of ``xs`` (``statistics.quantiles``)."""
    if len(xs) < 2:
        return list(xs)
    return [min(xs), *statistics.quantiles(xs, n=4), max(xs)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    os.chdir(ROOT)  # the planner calibrates from the checkout's root
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ.setdefault(var, str(ROOT / "build" / sub))
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from portbench import run
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    got = traced(run.load_json(ROOT / "BENCHMARK.json"), args.workload,
                 args.seed, args.seconds)
    tag = f"[join_spans {args.workload}]"
    for line in got["result"].pop("log"):
        print(tag, line)
    print(tag, "result", json.dumps(got["result"]))
    for key, val in got["program"].items():
        print(tag, key, json.dumps(val))
    got.update(workload=args.workload, seed=args.seed, card=run.card())
    print(json.dumps(got), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
