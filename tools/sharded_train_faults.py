"""Plant faults in the sharded train step and print what the smoke reads.

``chip_smoke.py``'s phase 6d holds qwen2-1.5b's (data, model) = (2, 2)
ZeRO-1 train step against the single-slot step on the same batch and
weights (``par_train``). This tool runs that comparison on the card for
the sound step and for two faults planted at run time (no file
changes), and prints each run's readings beside the smoke's tolerances
and what each run fails:

* ``one-group``: the second data group's gradients are zeros: a step
  that learns from half the batch;
* ``no-data-reduce``: each data slot keeps its own group's gradient (the
  reduce-scatter and the all-reduce over ``data`` left out, each piece
  scaled as if they had run).

The sound step must fail nothing and each fault something, or the tool
exits 1. Needs one CUDA card; from the repository's root::

    python3 tools/sharded_train_faults.py

The card's name and power limit are printed first.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402


def one_group(tp):
    """Zero every second call's gradients (the second data group's)."""
    orig, calls = tp.grad_sums, [0]

    def patched(*args, **kw):
        grads, losses, mets = orig(*args, **kw)
        calls[0] += 1
        if calls[0] % 2 == 0:
            grads = [torch.zeros_like(g) for g in grads]
        return grads, losses, mets
    return {"grad_sums": patched}


def no_data_reduce(tp):
    """Each slot's own gradient (its piece of it, along the ZeRO-1
    dimension) where the data reduction would run, times the count of
    data slots (the step divides by it later)."""
    def local(per_slot, zd, groups, devices):
        out = list(per_slot)
        for grp in groups:
            n = len(grp)
            for i, s in enumerate(grp):
                x = per_slot[s]
                if zd is not None:
                    step = x.shape[zd] // n
                    x = x.narrow(zd, i * step, step)
                out[s] = x * n
        return out
    return {"_reduce_over_data": local}


def main() -> int:
    if not torch.cuda.is_available():
        print("sharded_train_faults: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.train import parallel as tp
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    cfg, opt, batch, ref, master, _ = smoke.par_train_reference(dev)
    print(f"tolerances: loss {smoke.PAR_LOSS_TOL}, grad norm "
          f"{smoke.PAR_GNORM_TOL}, median {smoke.PAR_MEDIAN_TOL} x lr, "
          f"largest {smoke.PAR_FLIPS} x the steps' lrs", flush=True)
    ok = True
    for name, plant in (("sound", None), ("one-group", one_group),
                        ("no-data-reduce", no_data_reduce)):
        saved = {}
        if plant is not None:
            for attr, fn in plant(tp).items():
                saved[attr] = getattr(tp, attr)
                setattr(tp, attr, fn)
        try:
            _, state, got, _, _, _ = smoke.par_train_sharded(
                {}, dev, cfg, opt, batch)
        finally:
            for attr, fn in saved.items():
                setattr(tp, attr, fn)
        r = smoke.par_train_readings(state, got, ref, master)
        del state
        torch.cuda.empty_cache()
        fails = smoke.par_train_faults(r)
        ok &= (not fails) if plant is None else bool(fails)
        print(json.dumps({"run": name, "readings": r, "fails": fails,
                          "grad_norm": [g["grad_norm"] for g in got],
                          "one_slot_grad_norm": [g["grad_norm"]
                                                 for g in ref]}),
              flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
