"""The control of a cell's check: the reference's sketch in the program's
place, which has to come out as not correct.

    python3 portbench/control.py --workload livej.lfvt --seconds 8 \
        --seeds 11 12 13

Each seed runs the cell as ``run.py`` does (the same data, op stream,
window and check), with ``repro_torch.join`` replaced by the reference
restricted to a seeded half of the universe (``reference.sketch_keep``):
a coordinated sampling estimate of Jaccard, the approximate join that
breaks the configuration's guarantee of an exact answer. Its readings
of the check's numbers are the upper readings that the limits are set
below. It prints one JSON line a seed. The benchmark's runs never run it.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent

#: seed of the control's half of the universe
SKETCH_SEED = 20250603


def sketch_join(made: dict, device, universe: int):
    """A join with ``repro_torch.join``'s call and result that answers
    with the reference's sketch over ``made``'s sets."""
    import numpy as np

    from portbench import reference
    keep = reference.sketch_keep(universe, SKETCH_SEED, device)

    def join(R, S, t, **kw):
        rows = np.asarray(R.ids, np.int64)
        got = reference.pairs(made["pool"], rows, made["s"], universe, t,
                              device, keep=keep)
        return SimpleNamespace(
            pairs=frozenset((int(rows[a]), b) for a, b in got),
            stats={"method": "control"})
    return join


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import run
    if not torch.cuda.is_available():
        print("the control runs on a CUDA device", file=sys.stderr)
        return 2
    bench = run.load_json(ROOT / "BENCHMARK.json")
    universe = run.cell_parts(bench, args.workload)[1]["universe"]
    for seed in args.seeds:
        out = run.run_cell(
            bench, args.workload, seed, args.seconds, False, "cuda",
            time.perf_counter(),
            make_join=lambda made, dev: sketch_join(made, dev, universe))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": out["correct"],
                          "attempted": out["attempted"],
                          "checks": out["checks"], "log": out["log"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
