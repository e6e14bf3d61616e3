"""Time the bitmap AND-popcount kernels K2/K3 of one checkout on the card.

Runs against whichever ``repro_torch`` comes first on ``PYTHONPATH``, so
two checkouts compare in one call on one card (run them in turns: A, B,
B, A)::

    PYTHONPATH=<checkout>/src python tools/bitmap_join_ab.py --label <name>

The operands, the timing and the check are ``chip_smoke.py``'s
(``tiled_operands``, ``tiled_check``: CUDA events over 10 launches after
one warm-up, again with the launches queued behind a spin kernel, and
every output bit-equal to the plain version on the card). Two cases:
the livej-shaped join's (``make_join_dataset("livej", 20/3, seed=0)``)
R block 22 (rows 22 528-23 551) against the size-sorted S at t = 0.8,
and the kosarak-shaped measures data (``make_join_dataset("kosarak",
0.8, seed=0)``, dense words) first 1 024 R rows at t = 0.5. Wrappers
that take the compressed S (``s_sparse``) get it built once beforehand,
as the join driver builds it once per S; its build time is reported
apart. Prints one JSON line per case: the card, the K2 and K3
milliseconds and a SHA-256 of each output, equal across checkouts when
their kernels agree. The datasets are made once and kept in ``--data``
(an npz).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# the checkout under test first: chip_smoke puts its own src/ on sys.path,
# and the package's submodules then still come from this one
import repro_torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as smoke  # noqa: E402

CASES = (("livej", 20 / 3, 22, 0.8), ("kosarak", 0.8, 0, 0.5))


def collections(data: Path):
    """{name: (R block rows, S)} from ``data``, made first if missing."""
    from repro_torch.core.sets import SetCollection
    if not data.exists():
        from repro_torch.data.synth import make_join_dataset
        arrays = {}
        for name, scale, block, _ in CASES:
            R, S = make_join_dataset(name, scale, 0)
            rows = R.sets[block * smoke.BLOCK_ROWS:
                          (block + 1) * smoke.BLOCK_ROWS]
            for side, sets, universe in (("r", rows, R.universe),
                                         ("s", S.sets, S.universe)):
                arrays[f"{name}_{side}"] = np.concatenate(sets)
                arrays[f"{name}_{side}_len"] = np.array([len(x)
                                                         for x in sets])
                arrays[f"{name}_{side}_u"] = np.array(universe)
        data.parent.mkdir(parents=True, exist_ok=True)
        np.savez(data, **arrays)
    z = np.load(data)
    return {name: [SetCollection.from_ragged(
        np.split(z[f"{name}_{side}"],
                 np.cumsum(z[f"{name}_{side}_len"])[:-1]),
        universe=int(z[f"{name}_{side}_u"])) for side in ("r", "s")]
        for name, *_ in CASES}


def digest(out) -> str:
    h = hashlib.sha256()
    for x in out:
        h.update(x.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--label", required=True)
    ap.add_argument("--data", type=Path,
                    default=Path("build/bitmap_join_ab.npz"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bitmap_join_ab: needs a CUDA GPU")
    from repro_torch.kernels import bitmap_join as bj
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    for (name, _, _, t), (R, S) in zip(CASES,
                                       collections(args.data).values()):
        Ss = S.sort_by_size()
        W = max((max(R.universe, Ss.universe) + 31) // 32, 1)
        s_bm = torch.tensor(Ss.bitmaps(W).view(np.int32), device=dev)
        case = smoke.tiled_operands(R, Ss, slice(0, len(R)), t, "bitmap",
                                    None, dev, s_bm)
        row = {"label": args.label, "card": card, "torch": torch.__version__,
               "package": repro_torch.__file__, "case": name, "t": t,
               "rows": len(R), "columns": len(Ss), "words": W,
               "tiles": case[3], "live_tiles": len(case[2][0])}
        kw = {}
        if hasattr(bj, "compress_s"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            kw["s_sparse"] = bj.compress_s(case[0][2])
            torch.cuda.synchronize()
            row["compress_s_s"] = time.perf_counter() - t0
        for kid in ("K2", "K3"):
            got, _, ms, plain_ms, pairs, queued = smoke.tiled_check(
                kid, case, t, True, **kw)
            row.update({f"{kid}_digest": digest(got), f"{kid}_pairs": pairs,
                        f"{kid}_ms": ms, f"{kid}_queued_ms": queued,
                        f"{kid}_plain_ms": plain_ms})
        row["plain_equal"] = True
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
