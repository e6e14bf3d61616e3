"""Time the LFVT walk's plain version on all of a block's live tiles and
on the few with the most lane steps, on the card.

The plain walk (``kernels/lfvt_walk.lfvt_walk_live_tiled_ref``) holds
K1 and K6 in ``chip_smoke.py``. It runs in lockstep, one step a chain
position, until its longest live lane ends, so its time follows the
longest lane of the tiles it walks as much as their number. This tool
measures how much walking only the tiles with the largest lane budget
(the sum of their lanes' ``lane_rem``) saves, on the livej-shaped data
(``make_join_dataset("livej", --scale, seed=0)``, S size-sorted) and R's
first 1 024 rows, at t = 0.8 and 0.5::

    PYTHONPATH=src python tools/plain_walk_subset.py --scale 1.0

Prints one line per (t, tiles): the host seconds of one plain call
(synchronised), the largest per-tile step count of the walk, and
whether its outputs on those tiles equal K1's, and the card's name and
power limit first.
"""
from __future__ import annotations

import argparse
import subprocess
import time

import torch

from repro_torch import global_config
from repro_torch.core.tile_join import window_bounds
from repro_torch.data.synth import make_join_dataset
from repro_torch.kernels import lfvt_walk, ops


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--tiles", type=int, nargs="*", default=[8, 2])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("plain_walk_subset: needs a GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    R, S = make_join_dataset("livej", args.scale, 0)
    Ss = S.sort_by_size()
    flat = Ss.flat_lfvt()
    tm = global_config.row_tile
    rows = slice(0, 1024)
    r_pad = torch.tensor(R.padded()[0][rows], device=dev)
    r_sz = R.sizes()[rows]
    print(f"livej scale={args.scale} |R|={len(R)} max_seq_len="
          f"{flat.max_seq_len} rows=0..1023")
    for t in (0.8, 0.5):
        lo, hi = window_bounds(r_sz, flat.s_sizes, t)
        ti, operands, _ = ops.walk_operands(flat, r_pad, r_sz, lo, hi, tm)
        kw = dict(t=t, measure="jaccard", max_steps=int(flat.max_seq_len),
                  tm=tm)
        got = lfvt_walk.lfvt_walk_live_tiled(ti, *operands, **kw)
        budget = operands[1].reshape(-1, tm, operands[1].shape[1])[
            ti.long()].sum(dim=(1, 2))
        order = torch.argsort(budget, descending=True)
        for n in [len(ti)] + args.tiles:
            sel = order[:n].sort().values
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = lfvt_walk.lfvt_walk_live_tiled_ref(ti[sel], *operands,
                                                      **kw)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            equal = all(torch.equal(g[sel], w) for g, w in zip(got, want))
            print(f"t={t} tiles={n}/{len(ti)} plain_s={secs:.3f} "
                  f"walk_steps_max={int(want[2].max())} lane_budget="
                  f"{int(budget[sel].sum())} equal_to_K1={equal}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
