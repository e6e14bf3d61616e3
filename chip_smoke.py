"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (sm_90a, H100).

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It drives the port (``src/repro_torch``) only — no jax, no ``repro`` —
through these phases, in order; any failure raises and exits non-zero:

  1. print the card (``nvidia-smi`` name and power limit) and build every
     CUDA kernel from ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per
     source, all at once);
  2. join phase: ``repro_torch.join(R, S, 0.8, method="lfvt")`` on the
     card with the ``livej``-shaped dataset (|R| = |S| = 100 000), the K1
     launch count read around it, and its pairs for 64 sampled R rows
     (half at random, half among rows with pairs) held against exact
     overlaps computed here with numpy; then the join repeated, once on
     the host clock and once under ``torch.profiler`` (device-busy time,
     K1's share, the idle share);
  3. kernel phase: the 1024-row R block, as the driver cuts it, that
     holds the most paired rows of the join, size-sorted and tile-padded
     as the dispatch makes it, against the full S, at t = 0.8 and at
     t = 0.5: K1 and its plain PyTorch version on the card must give
     bit-equal masks, counts, ``walk_steps`` and ``early_stops``, with at
     least one pair at each threshold; both are timed with CUDA events at
     t = 0.8, and the lane steps and counters are checked against a numpy
     count written here;
  4. measures phase: at |R| = |S| = 4 000 (``dblp``-shaped), all 4
     measures x t in {0.5, 0.7, 0.9, 2/3} x both emit modes, the port on
     the card and the port on the CPU (in worker processes) must give
     identical pairs and walk counters;
  5. one ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}`` line.

Exits 2 without a result when torch sees no CUDA device.
"""
from __future__ import annotations

import json
import multiprocessing
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

MEASURES = ("jaccard", "cosine", "dice", "overlap")
THRESHOLDS = (0.5, 0.7, 0.9, 2 / 3)
MAIN_T = 0.8
WIDE_T = 0.5               # a second kernel check with many more pairs
MAIN_SCALE = 20 / 3        # livej: 15 000 x 20/3 = 100 000 sets a side
BLOCK_ROWS = 1024          # the driver's default r_block
ORACLE_ROWS = 64
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
# int32 scalar ops: the data sheet's 67 TFLOP/s of float32 counts an FMA
# as two operations on 128 float32 lanes per SM; Hopper has 64 int32
# lanes per SM, one operation each
INT32_OPS_PER_S = 67e12 / 4
COUNTERS = ("pair_count", "live_tiles", "total_tiles", "walk_steps",
            "early_stops", "regrows", "r_blocks")
NOT_PORTED = [
    ("K2", "bitmap_join_live_tiled", "src/repro/kernels/bitmap_join.py:157"),
    ("K3", "bitmap_join_tiled", "src/repro/kernels/bitmap_join.py:94"),
    ("K4", "onehot_join_live_tiled", "src/repro/kernels/onehot_join.py:145"),
    ("K5", "onehot_join_tiled", "src/repro/kernels/onehot_join.py:87"),
    ("K6", "lfvt_walk_planned", "src/repro/kernels/lfvt_walk.py:510"),
    ("K7", "flash_attention_bhld",
     "src/repro/kernels/flash_attention.py:82"),
]


def log(*args) -> None:
    print(*args, flush=True)


def cpu_join(task):
    """Pool worker: one port join on the CPU -> (pairs, counters)."""
    import repro_torch
    torch.set_num_threads(1)
    R, S, measure, t, emit = task
    st: dict = {}
    res = repro_torch.join(R, S, t, method="lfvt", measure=measure,
                           emit=emit, device="cpu", stats=st)
    return sorted(res.pairs), {k: st[k] for k in COUNTERS}


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` on the card over ``reps`` calls,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def lane_counts(Ss, r_sets, order, lo_p, hi_p, live_tiles, tm):
    """Per live tile, from the sorted S's element -> row index alone:
    (lane steps, in-window steps, walk_steps, early_stops).

    The lane of element ``a`` in row ``r`` walks the rows of the S sets
    holding ``a`` from the largest row down; it steps once per row >=
    lo, plus once onto the first row < lo (where it stops, counted as an
    early stop when two or more rows remained). It adds 1 to its count
    only at rows in [lo, hi)."""
    indptr, setids = Ss.csr()  # rows ascending within each element
    n = len(Ss)
    key = (np.repeat(np.arange(len(indptr) - 1, dtype=np.int64),
                     np.diff(indptr)) * (n + 1) + setids)
    out = []
    for tile in live_tiles:
        steps = win = tile_steps = stops = 0
        for p in range(tile * tm, tile * tm + tm):
            if p >= len(order):
                continue
            a = r_sets[order[p]].astype(np.int64)
            ln = indptr[a + 1] - indptr[a]
            a, ln = a[ln > 0], ln[ln > 0]
            if not len(a):
                continue
            below_lo = np.searchsorted(key, a * (n + 1) + lo_p[p]) - indptr[a]
            below_hi = np.searchsorted(key, a * (n + 1) + hi_p[p]) - indptr[a]
            ge = ln - below_lo
            k = np.minimum(ln, ge + 1)
            steps += int(k.sum())
            win += int(np.maximum(below_hi - below_lo, 0).sum())
            tile_steps = max(tile_steps, int(k.max()))
            stops += int((ln - ge >= 2).sum())
        out.append((steps, win, tile_steps, stops))
    return np.asarray(out, np.int64).reshape(-1, 4)


def oracle_pairs(R, S, rows, t):
    """Exact float64 Jaccard pairs of the given R rows against all of S:
    overlaps from np.isin over S's flattened elements."""
    s_flat = np.concatenate(S.sets)
    bounds = np.concatenate([[0], np.cumsum(S.sizes(), dtype=np.int64)])
    s_sz = S.sizes().astype(np.float64)
    got = set()
    for i in rows:
        hit = np.concatenate([[0], np.cumsum(np.isin(s_flat, R.sets[i]))])
        f = (hit[bounds[1:]] - hit[bounds[:-1]]).astype(np.float64)
        r_sz = float(len(R.sets[i]))
        with np.errstate(invalid="ignore", divide="ignore"):
            sim = f / (r_sz + s_sz - f)
        for j in np.nonzero((f > 0) & (sim >= t))[0]:
            got.add((int(R.ids[i]), int(S.ids[j])))
    return got


def device_profile(fn):
    """Run ``fn()`` under ``torch.profiler`` -> (wall s, device-busy s,
    K1 s, the five kernels with the most device time). Only device-side
    events (kernels, copies, memsets) count, never the CPU ops that
    issue them; device-busy time is the union of their intervals. 0.0
    when the profiler saw no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, per = [], {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        start, end = ev.time_range.start, ev.time_range.end
        spans.append((start, end))
        per[ev.name] = per.get(ev.name, 0.0) + (end - start) / 1e6
    busy, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            busy += end - max(start, reach)
            reach = end
    k1 = sum(v for k, v in per.items() if "lfvt_walk_kernel" in k)
    top = sorted(per.items(), key=lambda kv: -kv[1])[:5]
    return wall, busy / 1e6, k1, top


def kernel_check(Ss, flat, R, block, t, dev):
    """K1 against its plain version on one driver block of R at ``t``
    -> (K1's outputs, operands, max_abs_err, K1 ms, plain ms)."""
    from repro_torch import global_config
    from repro_torch.core.tile_join import window_bounds
    from repro_torch.kernels import lfvt_walk, ops
    tm = global_config.row_tile
    rows = slice(block * BLOCK_ROWS, (block + 1) * BLOCK_ROWS)
    r_pad = torch.tensor(R.padded()[0][rows], device=dev)
    r_sz = R.sizes()[rows]
    lo, hi = window_bounds(r_sz, flat.s_sizes, t)
    ti, operands, row_map = ops.walk_operands(flat, r_pad, r_sz, lo, hi, tm)
    kw = dict(t=t, measure="jaccard", max_steps=int(flat.max_seq_len), tm=tm)

    def k1():
        return lfvt_walk.lfvt_walk_live_tiled(ti, *operands, **kw)

    got = k1()
    torch.cuda.synchronize()
    ms = cuda_ms(k1, 3)
    lfvt_walk.lfvt_walk_live_tiled_ref(ti[:1], *operands, **kw)  # warm
    torch.cuda.synchronize()
    ev = (torch.cuda.Event(enable_timing=True),
          torch.cuda.Event(enable_timing=True))
    ev[0].record()
    want = lfvt_walk.lfvt_walk_live_tiled_ref(ti, *operands, **kw)
    ev[1].record()
    torch.cuda.synchronize()
    err = 0
    for name, g, w in zip(("masks", "counts", "walk_steps", "early_stops"),
                          got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"K1 {name} at t={t}: {g.shape}/{g.dtype} "
                                 f"vs plain {w.shape}/{w.dtype}")
        err = max(err, int((g.long() - w.long()).abs().max()))
    if err:
        raise AssertionError(f"K1 disagrees with its plain version at t={t}: "
                             f"max_abs_err={err}")
    if int(got[1].sum()) <= 0 or int(got[0].sum()) != int(got[1].sum()):
        raise AssertionError(f"K1 found no pairs in block {block} at t={t}; "
                             "the comparison would not hold the mask")
    order = row_map.cpu().numpy()
    lanes = lane_counts(Ss, R.sets[rows], order[order >= 0],
                        operands[6][:, 0].cpu().numpy(),
                        operands[7][:, 0].cpu().numpy(), ti.cpu().numpy(), tm)
    if not (np.array_equal(lanes[:, 2], got[2][:, 0].cpu().numpy())
            and np.array_equal(lanes[:, 3], got[3][:, 0].cpu().numpy())):
        raise AssertionError(f"K1 walk_steps/early_stops at t={t} disagree "
                             "with the numpy lane count")
    return (got, (ti, *operands), lanes, err, ms,
            ev[0].elapsed_time(ev[1]))


def k1_bound(operands, got, lanes):
    """(bound ms, bound_by, bytes, operations) of one K1 call: every input
    read once and every output written once at the HBM rate, against the
    integer work these inputs need at the int32 rate (per lane step a
    window compare and a step count, per in-window step one count add,
    per in-window mask cell ~4 ops of the predicate)."""
    moved = (sum(x.numel() * x.element_size() for x in operands)
             + sum(x.numel() * x.element_size() for x in got))
    lo, hi = operands[7].long(), operands[8].long()
    tm = got[0].shape[1]
    live_rows = (operands[0].long()[:, None] * tm
                 + torch.arange(tm, device=lo.device)).reshape(-1)
    cells = int((hi[live_rows] - lo[live_rows]).clamp(min=0).sum())
    lane_steps, win_steps = int(lanes[:, 0].sum()), int(lanes[:, 1].sum())
    ops_n = 2 * lane_steps + win_steps + 4 * cells
    byte_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops_n / INT32_OPS_PER_S * 1e3
    return (max(byte_ms, ops_ms), "bytes" if byte_ms >= ops_ms
            else "operations", moved, ops_n)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this script needs "
              "one GPU", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch.data.synth import make_join_dataset
    from repro_torch.kernels import _build, lfvt_walk

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")

    # ---- phase 1: build ------------------------------------------------ #
    t0 = time.perf_counter()
    took = _build.build(extra_flags=("-Xptxas", "-v"))
    log(f"[build] {json.dumps(took)} total_s={time.perf_counter() - t0:.3f}")

    # the measures phase's CPU side runs in worker processes meanwhile
    R4, S4 = make_join_dataset("dblp", scale=0.8, seed=0)
    configs = [(m, t, e) for m in MEASURES for t in THRESHOLDS
               for e in ("pairs", "mask")]
    pool = multiprocessing.get_context("spawn").Pool(6)
    try:
        cpu_async = pool.map_async(
            cpu_join, [(R4, S4, m, t, e) for m, t, e in configs])

        # ---- data --------------------------------------------------- #
        t0 = time.perf_counter()
        R, S = make_join_dataset("livej", scale=MAIN_SCALE, seed=0)
        gen_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        Ss = S.sort_by_size()
        flat = Ss.flat_lfvt()
        enc_s = time.perf_counter() - t0
        log(f"[data] livej |R|={len(R)} |S|={len(S)} "
            f"elements={R.total_elements()}+{S.total_elements()} "
            f"gen_s={gen_s:.3f} encode_s={enc_s:.3f} "
            f"seq_tuples={len(flat.seq_row)} max_seq_len={flat.max_seq_len}")

        # ---- phase 2: the join at full size ------------------------- #
        lfvt_walk.lfvt_walk_live_tiled.launches = 0
        torch.cuda.reset_peak_memory_stats()
        st: dict = {}
        t0 = time.perf_counter()
        res = repro_torch.join(R, Ss, MAIN_T, method="lfvt", stats=st)
        join_s = time.perf_counter() - t0
        launches = lfvt_walk.lfvt_walk_live_tiled.launches
        if launches <= 0:
            raise AssertionError("the join never launched K1")
        peak = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()
        again = repro_torch.join(R, Ss, MAIN_T, method="lfvt")
        warm_s = time.perf_counter() - t0
        if again.pairs != res.pairs:
            raise AssertionError("a repeated join gave other pairs")
        prof_wall, busy, k1_dev, top = device_profile(
            lambda: repro_torch.join(R, Ss, MAIN_T, method="lfvt"))
        log(f"[profile] warm join under torch.profiler: wall_s="
            f"{prof_wall:.3f} device_busy_s={busy:.3f} k1_device_s="
            f"{k1_dev:.3f} idle_share="
            f"{1 - busy / prof_wall if busy else 'not measured'} top="
            + json.dumps([[k[:60], round(v, 6)] for k, v in top]))
        # half the oracle rows at random, half among rows with pairs (at
        # t = 0.8 most rows have none)
        rng = np.random.default_rng(0)
        row_of = {int(i): k for k, i in enumerate(R.ids)}
        paired = np.unique([row_of[a] for a, _ in res.pairs])
        rows = np.unique(np.concatenate([
            rng.choice(len(R), ORACLE_ROWS // 2, replace=False),
            rng.permutation(paired)[:ORACLE_ROWS // 2]]).astype(np.int64))
        want_pairs = oracle_pairs(R, S, rows, MAIN_T)
        sampled = {int(R.ids[i]) for i in rows}
        got_pairs = {p for p in res.pairs if p[0] in sampled}
        if got_pairs != want_pairs:
            raise AssertionError(
                f"join pairs of the sampled rows differ from the oracle: "
                f"{len(got_pairs)} vs {len(want_pairs)}")
        log(f"[join] pairs={len(res.pairs)} wall_s={join_s:.3f} "
            f"warm_wall_s={warm_s:.3f} r_blocks={st['r_blocks']} "
            f"live_tiles={st['live_tiles']}/{st['total_tiles']} "
            f"walk_steps={st['walk_steps']} early_stops={st['early_stops']} "
            f"regrows={st['regrows']} s_flat_bytes={st['s_flat_bytes']} "
            f"max_memory_allocated={peak} k1_launches={launches} "
            f"oracle_rows={len(rows)} oracle_pairs={len(want_pairs)}")

        # ---- phase 3: K1 against its plain version ------------------ #
        # the driver's block (rows cut in input order) with the most rows
        # that the join paired, so the main threshold's mask is not empty
        block = int(np.bincount(paired // BLOCK_ROWS).argmax()
                    if len(paired) else 0)
        checks = {t: kernel_check(Ss, flat, R, block, t, dev)
                  for t in (MAIN_T, WIDE_T)}
        got, operands, lanes, _, ms, plain_ms = checks[MAIN_T]
        err = max(c[3] for c in checks.values())
        bound_ms, bound_by, moved, ops_n = k1_bound(operands, got, lanes)
        lane_steps, win_steps = int(lanes[:, 0].sum()), int(lanes[:, 1].sum())
        # the walk's dependent-gather traffic (8 B of seq_row/seq_next per
        # lane step, a 4 B count update per in-window step): what K1 moves
        # through the caches, beside the bytes the function must move
        step_bytes = 8 * lane_steps + 4 * win_steps
        for t, c in checks.items():
            log(f"[kernel] t={t} block={block} K1 vs plain bit-equal: "
                f"live_tiles={len(c[1][0])} Lr={c[1][1].shape[1]} "
                f"NP={c[1][5].shape[1]} pairs={int(c[0][1].sum())} "
                f"walk_steps={int(c[0][2].sum())} "
                f"early_stops={int(c[0][3].sum())} "
                f"lane_steps={int(c[2][:, 0].sum())} "
                f"window_steps={int(c[2][:, 1].sum())} ms={c[4]:.4f} "
                f"plain_ms={c[5]:.4f}")
        log(f"[bound] t={MAIN_T} bound_ms={bound_ms:.6f} bound_by={bound_by} "
            f"bytes={moved} int32_ops={ops_n} k1_over_bound="
            f"{ms / bound_ms:.1f} step_traffic_bytes={step_bytes} "
            f"step_traffic_gb_per_s={step_bytes / ms / 1e6:.1f}")

        # ---- phase 4: every measure, cuda vs cpu -------------------- #
        t0 = time.perf_counter()
        cuda_out = []
        for m, t, e in configs:
            st4: dict = {}
            r4 = repro_torch.join(R4, S4, t, method="lfvt", measure=m,
                                  emit=e, stats=st4)
            cuda_out.append((sorted(r4.pairs),
                             {k: st4[k] for k in COUNTERS}))
        cpu_out = cpu_async.get()
        for (m, t, e), a, b in zip(configs, cuda_out, cpu_out):
            if a != b:
                raise AssertionError(f"cuda and cpu differ at measure={m} "
                                     f"t={t} emit={e}")
        log(f"[measures] |R|=|S|={len(R4)} configs={len(configs)} "
            f"cuda==cpu pairs={[len(a[0]) for a in cuda_out[::2]]} "
            f"s={time.perf_counter() - t0:.3f}")
    finally:
        pool.terminate()
        pool.join()

    kernels = [{
        "name": "lfvt_walk_live_tiled", "id": "K1", "status": "ported",
        "route": "cuda", "source": "src/repro_torch/kernels/csrc/lfvt_walk.cu",
        "replaces": "src/repro/kernels/lfvt_walk.py:426",
        "launches": launches, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,
        "check": (f"bit-equal to lfvt_walk_live_tiled_ref on the card at "
                  f"t={MAIN_T} and t={WIDE_T}")}]
    not_ported = [{"id": k, "name": n, "status": "not_ported", "replaces": r}
                  for k, n, r in NOT_PORTED]
    print(json.dumps({"kernels": kernels, "not_ported": not_ported}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
