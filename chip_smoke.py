"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (sm_90a, H100).

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It drives the port (``src/repro_torch``) only — no jax, no ``repro`` —
through these phases, in order; any failure raises and exits non-zero:

  1. print the card (``nvidia-smi`` name and power limit) and build every
     CUDA kernel from ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per
     source, all at once), with the registers, spills and static shared
     memory of K7's, K4/K5's, K1/K6's and K2/K3's kernels as ``nvcc
     -Xptxas -v`` reports them and the dynamic shared memory a K4/K5 or
     K2/K3 CTA asks for and a K1/K6 CTA may ask for;
  2. measures phase: at |R| = |S| = 4 000, all 4 measures x
     t in {0.5, 0.7, 0.9, 2/3} x both emit modes, for ``lfvt``
     (``dblp``-shaped) and for ``popcount``, ``onehot``,
     ``kernel_bitmap`` and ``kernel_onehot`` (``kosarak``-shaped),
     through the port's driver on the card and, meanwhile, in CPU worker
     processes (one of which makes the livej data first); the two must
     give identical pairs (compared as sorted int64 keys) and counters.
     For each measure and emit mode one of the four bitmap methods also
     runs through ``repro_torch.join`` on the card at t = 0.9, and its
     pairs (and mask) must equal the CPU driver's. Then the MapReduce
     driver (``repro_torch.mr_cf_rs_join``, 4 load-aware shards) on the
     same data, on the card and in the workers (``mr_configs``): every
     method and ``auto``, each measure at its ``MR_T`` (dice at exactly
     2/3), both emits; ``hash`` with ``lfvt``; one managed run per
     measure under a seeded ``MR_FAULT_PLANS`` plan, whose pairs and
     resilience counters must equal the CPU's and whose only
     degradations may be the injected ones. Meanwhile one MR join runs in
     a child process on the card with a checkpoint directory and is
     killed (SIGKILL) at its 2nd checkpoint write; a second child
     resumes it and must give the uninterrupted run's pairs. The pool is
     done before any timed phase starts;
  3. join phase: ``repro_torch.join(R, S, 0.8, method="lfvt")`` on the
     card with the ``livej``-shaped dataset (|R| = |S| = 100 000), the K1
     launch count read around it, and its pairs for 64 sampled R rows
     (half at random, half among rows with pairs) held against exact
     overlaps computed here with numpy; then the join repeated, once on
     the host clock and once under ``torch.profiler`` (device-busy time,
     K1's share, the idle share);
  4. front-door phase: ``repro_torch.join(R, S, 0.8)`` with no method
     (``method="auto"``; it picks ``popcount``, kernel K3) at the same
     size, cold, warm and profiled; then ``kernel_bitmap`` and
     ``kernel_onehot`` with ``emit="pairs"`` (K2, K4) and ``onehot``
     (K5). Every launch count is set to 0 just before each of these runs
     and read just after; each run must launch its kernel and give the
     lfvt join's pairs. Then ``kernel_bitmap``, ``kernel_onehot`` and
     ``onehot`` again, warm (the default call's pairs), and
     ``kernel_bitmap`` and ``kernel_onehot`` under ``torch.profiler``
     (device-busy time, K2's or K4's share, the idle share); then the
     MapReduce driver at the same size: ``repro_torch.join(R, S, 0.8,
     n_shards=8)`` with ``lfvt`` (cold, warm, profiled: K1 must launch
     once for each shard with a live row), ``auto`` (its per-shard picks
     printed) and ``kernel_bitmap`` (K2 per shard, profiled), each equal
     to the lfvt join's pairs, with the partition's ``psi``, intervals,
     shard loads, R replication and shuffle bytes, and the host's
     partition, routing and per-shard LFVT encode timed apart;
  5. serve phase: ``repro_torch.DedupServeEngine`` on the card, with the
     livej S side (100 000 sets) as its corpus, at t = 0.8. Stream A:
     4 096 requests (half exact copies of corpus sets, half livej R
     sets) in 256-request batches, once with ``schedule="device"`` (K6,
     which must launch once per batch) and once with ``"host"`` (K1);
     both must give the same results, equal to the per-request pairs of
     ``repro_torch.join(R_req, corpus, 0.8, method="lfvt")``; then a warm
     pass under ``torch.profiler``. Stream B: A's first 256 requests at
     the default micro-batch (16). Stream C: 1 024 requests, a quarter of
     them repeats, with ``admit="survivors"`` under both schedules
     (identical results, duplicates caught within and across batches),
     then K6 (and K1 on its live tiles) on a 256-row probe against the
     grown corpus, bit-equal to its plain version, with the count of the
     table's hops that do not lower the row, then ``compact()``, after
     which the probe must give the same pairs as on the grown corpus.
     Then K6 on a partial batch of A's last
     200 requests (its padding tiles dead) and on a copy with every other
     tile's windows emptied: bit-equal to its plain version and to K1 on
     the live tiles, zeros elsewhere, its plan and launch run under
     ``torch.cuda.set_sync_debug_mode("error")``, timed beside K1 and its
     bound, with its CTAs, shared bytes a CTA, column passes and the mean
     and largest number of runs a lane's scan touches. Wall time,
     requests/s and p50/p99 latency for each stream;
  6. LLM serve phase: qwen2-1.5b at full width and depth (28 layers,
     1.78 B parameters, bf16, seeded on the card, attention projections
     rescaled to 1/sqrt of the width they contract: see
     ``condition_attention``), built with ``attn_impl="flash"``, behind
     ``repro_torch.ServeEngine(max_seq_len=4096)``: 8 prompts of 2 048
     tokens (numpy, seed 0), a cold and a counted prefill (K7 must launch
     once per layer, 28 times), then 64 greedy tokens; prefill wall,
     decode tokens/s and peak memory. The same weights through an
     ``attn_impl="jnp"`` build: last-token logits within
     ``LLM_LOGIT_TOL`` and greedy tokens equal while the plain run's
     top-2 gap exceeds it (the steps compared are printed; the weights as
     drawn, before the rescaling, are compared too and only logged); then
     the prefill and 3 decode steps under ``torch.profiler`` (device-busy
     time, K7's share, the idle share, device events per step);
  7. kernel phase: the 1024-row R block, as ``cf_rs_join_device`` cuts
     it, that holds the most paired rows of the join, against the full S, at
     t = 0.8 and t = 0.5: K1 (size-sorted and tile-padded as its dispatch
     makes it) and K2-K5 (tile-padded as theirs do) must be bit-equal to
     their plain PyTorch versions on the card, with pairs at both
     thresholds (K1, with its CTAs, shared bytes a CTA, column passes and
     runs per lane) and at t = 0.5 (K2-K5), plus a small-tile case for
     K2-K5 and, for K2/K3, the kosarak block of dense words; all are
     timed with CUDA events at t = 0.8, beside their bound and one bf16
     ``torch.matmul`` of the block's unpacked membership matrices; K2/K3
     read the block's compressed S (its build time, pairs and bytes are
     logged with the work their schedule does: CTAs, covered cells,
     column-pair visits, union lengths) and their bound counts the words
     nonzero on both sides (one float32 product of the nonzero-word
     matrices), beside the dense figure of every word; K3's dispatch
     (``ops.bitmap_join``) is timed with the S sheet unpadded and
     pre-padded; K4/K5 add the live tiles' cells, the 128-bit stages
     with a set word on both sides (what they expand and multiply) and
     the int8 rate that makes; K7 against its plain version within the
     reference's tolerances at the ``K7_CASES``: the qwen2-1.5b prefill
     shape as the main path gives it (q at 12 heads, k and v at their 2
     KV heads, read in place: B = 8, L = 2 048, D = 128), the same shape
     in the merged (B*H, L, D) layout, a ragged L = 2 000, the
     starcoder2-3b shape with its window (24 heads, L = 8 192, window
     4 096; merged, and with its 2 KV heads in place) and two float32
     cases, each timed beside its bound and, without a window, beside
     one ``scaled_dot_product_attention(is_causal=True)`` (with
     ``enable_gqa=True`` for the in-place cases); the bf16 kernel's
     registers and spills as ``nvcc -Xptxas -v`` reports them;
  8. one ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}`` line.

Exits 2 without a result when torch sees no CUDA device. ``python3
chip_smoke.py --mr-child kill|resume DIR`` is the kill-and-resume
check's child, not a smoke run.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import itertools
import json
import multiprocessing
import os
import re
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
# CPU processes of the measures phase: all cores but the one that
# drives the card
POOL_WORKERS = max(1, min(7, (os.cpu_count() or 2) - 1))
ORACLE_ROWS = 64
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
# int32 scalar ops: the data sheet's 67 TFLOP/s of float32 counts an FMA
# as two operations on 128 float32 lanes per SM; Hopper has 64 int32
# lanes per SM, one operation each
INT32_OPS_PER_S = 67e12 / 4
INT8_OPS_PER_S = 1979e12   # dense int8 tensor-core rate (data sheet)
COUNTERS = ("pair_count", "live_tiles", "total_tiles", "walk_steps",
            "early_stops", "regrows", "r_blocks", "output_bytes")
BITMAP_METHODS = ("popcount", "onehot", "kernel_bitmap", "kernel_onehot")
# the measures phase: (dataset, methods), |R| = |S| = 4 000 each
MEASURE_SETS = (("dblp", ("lfvt",)), ("kosarak", BITMAP_METHODS))
# the CPU workers take the slowest joins first (the plain popcount is
# ~4x the one-hot product on the CPU), so that none is left to run alone
CPU_ORDER = ("popcount", "kernel_bitmap", "lfvt", "kernel_onehot", "onehot")
FRONT_DOOR_T = 0.9         # the measures phase's front-door calls
# the MapReduce driver (mr_cf_rs_join, loop path): the full-size phase's
# load-aware shards, and the measures phase's
MR_SHARDS = 8
MR_MEASURE_SHARDS = 4
# the measures phase's MR calls, load-aware: (dataset, methods, emits
# per measure, measures); each measure at its MR_T, the exact-2/3
# boundary with dice. The bitmap methods take one emit a measure, in
# turn (their plain versions cost the CPU workers 10-50 s a call), and
# the whole-block walk (lfvt_ref, 43 s a call there) two measures.
MR_T = {"jaccard": 0.5, "cosine": 0.7, "dice": 2 / 3, "overlap": 0.9}
MR_SETS = (("dblp", ("lfvt", "auto"), 2, MEASURES),
           ("dblp", ("lfvt_ref",), 1, MEASURES[:2]),
           ("kosarak", BITMAP_METHODS + ("auto",), 1, MEASURES))
# its managed runs, one per measure (dblp, lfvt, emit pairs): seeded
# plans whose only possible degradation is the injected one, the walk
# to the whole-block walk (oom, storm); the transient plans retry only
MR_FAULT_PLANS = {
    "jaccard": "compact:transient;flat_tables:corrupt",
    "cosine": "walk_dispatch:oom",
    "dice": "compact:storm",
    "overlap": "walk_dispatch:transient;compact:transient",
}
MR_COUNTERS = ("result_pairs", "regrows", "live_tiles", "total_tiles",
               "walk_steps", "early_stops", "reduce_bytes", "shard_methods",
               "retries", "degradations", "faults_injected",
               "guardrail_splits", "tasks_resumed")
# the kill-and-resume child: its join is the measures phase's first MR
# config, killed at its 2nd checkpoint write
MR_KILL_PLAN = "checkpoint_write:kill:2"
# the serve phase, on the livej S side as the corpus, at t = MAIN_T
SERVE_REQUESTS = 4096      # stream A: half corpus copies, half R sets
SERVE_BATCH = 256          # streams A and C: requests per micro-batch
SERVE_DEFAULT_REQUESTS = 256   # stream B, at the default micro-batch
ADMIT_REQUESTS = 1024      # stream C: a quarter repeats, admit survivors
PARTIAL_REQUESTS = 200     # K6's check: a partial batch (56 padding rows)
CSRC = "src/repro_torch/kernels/csrc"
# id -> (module, wrapper, plain version, source, TPU kernel it replaces)
KERNELS = {
    "K1": ("lfvt_walk", "lfvt_walk_live_tiled", "lfvt_walk_live_tiled_ref",
           f"{CSRC}/lfvt_walk.cu", "src/repro/kernels/lfvt_walk.py:426"),
    "K2": ("bitmap_join", "bitmap_join_live_tiled",
           "bitmap_join_live_tiled_ref", f"{CSRC}/bitmap_join.cu",
           "src/repro/kernels/bitmap_join.py:157"),
    "K3": ("bitmap_join", "bitmap_join_tiled", "bitmap_join_tiled_ref",
           f"{CSRC}/bitmap_join.cu", "src/repro/kernels/bitmap_join.py:94"),
    "K4": ("onehot_join", "onehot_join_live_tiled",
           "onehot_join_live_tiled_ref", f"{CSRC}/onehot_join.cu",
           "src/repro/kernels/onehot_join.py:145"),
    "K5": ("onehot_join", "onehot_join_tiled", "onehot_join_tiled_ref",
           f"{CSRC}/onehot_join.cu", "src/repro/kernels/onehot_join.py:87"),
    "K6": ("lfvt_walk", "lfvt_walk_planned", "lfvt_walk_planned_ref",
           f"{CSRC}/lfvt_walk.cu", "src/repro/kernels/lfvt_walk.py:510"),
    "K7": ("flash_attention", "flash_attention_bhld",
           "flash_attention_bhld_ref", f"{CSRC}/flash_attention.cu",
           "src/repro/kernels/flash_attention.py:82"),
}
# the main-path run of each kernel: the method whose full-size join it
# carries (K3 runs under the front door's default call), the served
# stream (K6: stream A under schedule="device"), or the LLM engine's
# prefill (K7)
MAIN_RUN = {"K1": "lfvt", "K2": "kernel_bitmap", "K3": "auto",
            "K4": "kernel_onehot", "K5": "onehot", "K6": "serve_device",
            "K7": "llm_prefill"}
#: TPU kernels without a counterpart on the card: none since K7
NOT_PORTED: list = []
# the LLM serve phase: qwen2-1.5b at full width and depth, bf16
LLM_ARCH = "qwen2-1.5b"
LLM_BATCH = 8              # prompts served together
LLM_PROMPT = 2048          # tokens per prompt (numpy, seed 0)
LLM_NEW = 64               # greedy tokens generated per prompt
LLM_CACHE = 4096           # the engine's max_seq_len (KV cache length)
DECODE_PROFILED = 3        # decode steps under torch.profiler
# the flash and the plain-attention prefill's last-token logits may
# differ by this fraction of the plain run's largest |logit| in each row.
# bf16 keeps 8 bits (2^-8 = 3.9e-3 per rounding), and the two paths round
# differently in each of the 28 layers (K7 rounds p after its online max;
# the plain path rounds the scores after QK^T and the probabilities after
# the softmax): independent errors add as a random walk, sqrt(28) x 2^-8
# = 2.1e-2 of the logit scale; 5e-2 leaves 2.5x of headroom. Greedy
# tokens are compared while the plain run's top-2 gap exceeds it.
LLM_LOGIT_TOL = 5e-2
BF16_OPS_PER_S = 989e12    # dense bf16 tensor-core rate (data sheet)
F32_OPS_PER_S = 67e12      # float32 outside the tensor cores (data sheet)
# K7 against its plain version: (label, B, L, H, KV, D, window, dtype).
# KV heads read in place through flash_attention_blhd, or, with KV None,
# the merged (B*H, L, D) layout of flash_attention_bhld (KV expanded).
# The first, the qwen2-1.5b prefill as the main path gives it to K7,
# gives the kernels line's numbers; the merged case at the same shape is
# the like-for-like comparison with earlier runs.
K7_CASES = (
    ("qwen2-1.5b prefill, GQA in place", 8, 2048, 12, 2, 128, None,
     torch.bfloat16),
    ("qwen2-1.5b prefill, merged", 8, 2048, 12, None, 128, None,
     torch.bfloat16),
    ("ragged, merged", 8, 2000, 12, None, 128, None, torch.bfloat16),
    ("starcoder2-3b prefill, window 4096, merged", 1, 8192, 24, None, 128,
     4096, torch.bfloat16),
    ("starcoder2-3b prefill, window 4096, GQA in place", 1, 8192, 24, 2,
     128, 4096, torch.bfloat16),
    ("float32", 1, 300, 4, None, 64, None, torch.float32),
    ("float32 windowed, GQA in place", 2, 300, 4, 2, 128, 50,
     torch.float32),
)
#: K7's kernels as torch.profiler names them
K7_KERNEL_NAMES = ("flash_attention_wgmma", "flash_attention_f32")
# the reference's tolerances for K7 (tests/test_flash_attention.py):
# bf16 rounds p to bf16 before P.V, the plain version keeps float32;
# float32 differs from the full softmax in summation order and exp only
K7_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}


T_START = time.perf_counter()


def log(*args) -> None:
    """Print one progress line, stamped with the seconds since start."""
    print(f"[{time.perf_counter() - T_START:7.1f}s]", *args, flush=True)


_WORKER_DATA: dict = {}


@functools.lru_cache(maxsize=None)
def measures_data(name: str):
    """The measures phase's |R| = |S| = 4 000 dataset ``name`` (made once
    a process)."""
    from repro_torch.data.synth import make_join_dataset
    return make_join_dataset(name, scale=0.8, seed=0)


def init_worker() -> None:
    """Pool initializer: each worker makes the measures datasets once."""
    torch.set_num_threads(1)
    for name, _ in MEASURE_SETS:
        _WORKER_DATA[name] = measures_data(name)


def pair_digest(r_ids, s_ids) -> tuple[int, str]:
    """(count, SHA-256 of the sorted int64 keys r_id * 2^32 + s_id) of a
    join's pairs: equal for equal pair sets in every process, whatever
    order the blocks gave them in, at the cost of one sort (the kosarak
    overlap joins return 12 M pairs)."""
    keys = np.sort((np.asarray(r_ids, np.int64) << 32)
                   | (np.asarray(s_ids, np.int64) & 0xFFFFFFFF))
    return len(keys), hashlib.sha256(keys.tobytes()).hexdigest()


def port_join(R, S, method, measure, t, emit, device=None):
    """One join through the port's single-device driver, with the pairs
    as arrays -> (pair digest, counters)."""
    from repro_torch.core.tile_join import cf_rs_join_device_ids
    st: dict = {}
    r_ids, s_ids = cf_rs_join_device_ids(R, S, t, method=method,
                                         measure=measure, emit=emit,
                                         device=device, stats=st)
    return pair_digest(r_ids, s_ids), {k: st.get(k) for k in COUNTERS}


def front_door_join(R, S, method, measure, t, emit):
    """One join through ``repro_torch.join`` on the card -> (pair digest,
    counters), as ``port_join``; with ``emit='mask'`` the dense mask must
    hold exactly the pairs."""
    import repro_torch
    st: dict = {}
    res = repro_torch.join(R, S, t, method=method, measure=measure,
                           emit=emit, stats=st)
    pr = np.fromiter(itertools.chain.from_iterable(res.pairs), np.int64,
                     count=2 * len(res.pairs)).reshape(-1, 2)
    if emit == "mask":
        rows, cols = np.nonzero(res.mask)
        if not np.array_equal(np.sort(pr[:, 0] << 32 | pr[:, 1]),
                              np.sort(R.ids[rows].astype(np.int64) << 32
                                      | S.ids[cols].astype(np.int64))):
            raise AssertionError(f"the front door's mask is not its pairs "
                                 f"at {(method, measure, t, emit)}")
    return pair_digest(pr[:, 0], pr[:, 1]), {k: st.get(k) for k in COUNTERS}


def cpu_join(task):
    """Pool worker: one port join on the CPU -> (pairs, counters, the
    seconds it took)."""
    name, method, measure, t, emit = task
    t0 = time.perf_counter()
    out = port_join(*_WORKER_DATA[name], method, measure, t, emit, "cpu")
    return out, time.perf_counter() - t0


def mr_configs():
    """The measures phase's MR calls: (dataset, method, measure, t, emit,
    strategy, fault plan). ``hash`` runs the walk only: it puts all of S
    on every shard."""
    out = []
    for name, methods, n_emits, measures in MR_SETS:
        for method in methods:
            for k, m in enumerate(measures):
                out += [(name, method, m, MR_T[m], ("pairs", "mask")[
                    (k + j) % 2], "load_aware", None)
                    for j in range(n_emits)]
    for k, m in enumerate(MEASURES):
        out += [("dblp", "lfvt", m, MR_T[m], ("pairs", "mask")[k % 2],
                 "hash", None),
                ("dblp", "lfvt", m, MR_T[m], "pairs", "load_aware",
                 MR_FAULT_PLANS[m])]
    return out


def mr_join(R, S, cfg, device=None, **kw):
    """One ``mr_cf_rs_join`` call of ``mr_configs`` at MR_MEASURE_SHARDS
    shards -> (pair digest, counters)."""
    import repro_torch
    _, method, measure, t, emit, strategy, plan = cfg
    st: dict = {}
    pairs = repro_torch.mr_cf_rs_join(
        R, S, t, MR_MEASURE_SHARDS, strategy=strategy, method=method,
        measure=measure, emit=emit, fault_plan=plan, stats=st,
        device=device, **kw)
    pr = np.fromiter(itertools.chain.from_iterable(pairs), np.int64,
                     count=2 * len(pairs)).reshape(-1, 2)
    return pair_digest(pr[:, 0], pr[:, 1]), {k: st.get(k)
                                             for k in MR_COUNTERS}


def cpu_mr_join(cfg):
    """Pool worker: one MR join of ``mr_configs`` on the CPU -> (pairs,
    counters, the seconds it took)."""
    t0 = time.perf_counter()
    out = mr_join(*_WORKER_DATA[cfg[0]], cfg, "cpu")
    return out, time.perf_counter() - t0


def mr_child(phase: str, ckpt: str) -> int:
    """The kill-and-resume check's child process, on the card: the first
    MR config with ``checkpoint_dir=ckpt``; ``phase`` 'kill' arms
    MR_KILL_PLAN (the process dies at its 2nd checkpoint write), 'resume'
    prints the pair digest and the tasks it resumed as JSON."""
    cfg = mr_configs()[0]
    plan = MR_KILL_PLAN if phase == "kill" else None
    digest, st = mr_join(*measures_data(cfg[0]), cfg[:6] + (plan,),
                         checkpoint_dir=ckpt)
    print(json.dumps({"digest": digest, "tasks_resumed":
                      st["tasks_resumed"]}))
    return 0


def wrappers() -> dict:
    """Kernel id -> (wrapper, plain version)."""
    import importlib
    out = {}
    for kid, (mod, name, plain, _, _) in KERNELS.items():
        m = importlib.import_module(f"repro_torch.kernels.{mod}")
        out[kid] = (getattr(m, name), getattr(m, plain))
    return out


def counted(fn):
    """Run ``fn()`` with every kernel's launch count set to 0 just before
    -> (its result, {kernel id: launches during the run})."""
    ws = wrappers()
    for w, _ in ws.values():
        w.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {kid: w.launches for kid, (w, _) in ws.items()}


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


def queued_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` on the card over ``reps`` calls
    queued behind a ~25 ms spin kernel, after one warm-up call: the host
    enqueues the calls while the card spins, so its own time between
    calls (the wrapper's checks and launches) does not count, only the
    card's. For a call that is shorter on the card than on the host,
    where ``cuda_ms`` measures the host."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
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


def lane_runs(flat, operands, tiles, tm, max_steps):
    """Per lane of the rows of ``tiles`` (vectorised over lanes, one run
    of the walk at a time) -> (runs the lane's scan touches, its steps,
    its early stops) as the walk kernels' run scan takes them, and the
    per-tile (max steps, early stops) to hold against the kernel's
    counters. A run ends at a position whose hop (clamped at 0) is not
    the position below. Rows rise with the position inside a run of an
    ``encode()`` table (Theorem 3.3), so the run's first row below lo is
    found by binary search: valid on encode() tables only, which is what
    the comparison with the kernel's counters confirms."""
    seq = np.asarray(flat.seq_row, np.int64)
    hop = np.maximum(np.asarray(flat.seq_next, np.int64), 0)
    pos_all = np.arange(len(seq))
    run_lo = np.maximum.accumulate(np.where(hop != pos_all - 1, pos_all, 0))
    rows = (np.asarray(tiles, np.int64)[:, None] * tm
            + np.arange(tm)).reshape(-1)
    Lr = operands[0].shape[1]
    pos = operands[0].cpu().numpy()[rows].reshape(-1).astype(np.int64)
    rem = operands[1].cpu().numpy()[rows].reshape(-1).astype(np.int64)
    lo = np.repeat(np.maximum(operands[6].cpu().numpy()[rows, 0], 0), Lr)
    tile_of = np.repeat(np.arange(len(rows)) // tm, Lr)
    live = rem > 0
    pos, rem, lo, tile_of = pos[live], rem[live], lo[live], tile_of[live]
    runs = np.zeros(len(pos), np.int64)
    k = np.zeros(len(pos), np.int64)
    stop = np.zeros(len(pos), np.int64)
    act = np.nonzero(np.minimum(rem, max_steps) > 0)[0]
    while len(act):
        p, r0 = pos[act], run_lo[pos[act]]
        avail = np.minimum(rem[act], max_steps - k[act])
        # the run's positions [r0, p]: rows below lo form a prefix
        a, b = r0.copy(), p + 1
        while (a < b).any():
            open_ = a < b
            mid = (a + b) // 2
            below = seq[np.minimum(mid, len(seq) - 1)] < lo[act]
            a = np.where(open_ & below, mid + 1, a)
            b = np.where(open_ & ~below, mid, b)
        to_stop = np.where(a > r0, p - a + 2, np.iinfo(np.int64).max)
        in_run = np.where((p == r0) & (hop[p] == p), avail, p - r0 + 1)
        take = np.minimum(np.minimum(in_run, avail), to_stop)
        runs[act] += 1
        k[act] += take
        stopped = take == to_stop
        stop[act[stopped]] = rem[act[stopped]] - (take[stopped] - 1) > 1
        rem[act] -= take
        go = ~stopped & (take < avail)
        act = act[go]
        pos[act] = hop[r0[go]]
    n_tiles = len(rows) // tm
    tile_steps = np.zeros(n_tiles, np.int64)
    np.maximum.at(tile_steps, tile_of, k)
    return (runs, k, stop, tile_steps,
            np.bincount(tile_of, stop, n_tiles).astype(np.int64))


def walk_smem_bytes(cols: int) -> int:
    """The dynamic shared memory a walk CTA asks for at ``cols`` count
    columns (the library's ``lfvt_walk_smem_bytes``; 0 for a ``cols``
    the kernels refuse)."""
    from repro_torch.kernels import _build
    fn = _build.load("lfvt_walk").lfvt_walk_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return fn(cols)


def walk_launch(operands, lo_np, hi_np, n_slots, tm):
    """The walk kernels' launch for these operands, as the wrappers plan
    it: (CTAs, shared count columns, dynamic shared bytes a CTA, the most
    column passes a row takes, the widest window)."""
    from repro_torch.kernels import lfvt_walk
    NP = operands[4].shape[1]
    mw = int(np.maximum(np.asarray(hi_np) - np.asarray(lo_np), 0).max())
    cols = lfvt_walk.walk_pass_cols(NP)
    passes = int(lfvt_walk.walk_passes(lo_np, hi_np, NP, cols).max())
    return n_slots * tm, cols, walk_smem_bytes(cols), passes, mw


def walk_smem_lines() -> list[str]:
    """The most dynamic shared memory a walk CTA asks for, checked
    against the wrapper's plan (``lfvt_walk.WALK_MAX_COLS``)."""
    from repro_torch.kernels import lfvt_walk
    top = lfvt_walk.WALK_MAX_COLS
    if walk_smem_bytes(top) != 4 * top or walk_smem_bytes(top + 16):
        raise AssertionError("lfvt_walk.WALK_MAX_COLS is not the kernel's "
                             "largest column pass")
    return [f"lfvt_walk_kernel / lfvt_walk_planned_kernel: "
            f"dynamic_smem_bytes<={walk_smem_bytes(top)} "
            f"(cols<={top}; each launch asks for NP rounded up to 16)"]


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


def device_profile(fn, keys):
    """Run ``fn()`` under ``torch.profiler`` -> (wall s, device-busy s,
    seconds of the kernels whose name holds one of ``keys``, the five
    kernels with the most device time, the number of device events).
    Only device-side events (kernels, copies, memsets) count, never the
    CPU ops that launch them; device-busy time is the union of their
    intervals. 0.0 when the profiler saw no device events."""
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
    mine = sum(v for k, v in per.items() if any(key in k for key in keys))
    top = sorted(per.items(), key=lambda kv: -kv[1])[:5]
    return wall, busy / 1e6, mine, top, len(spans)


def log_profile(label, prof, kernel_id):
    wall, busy, mine, top, events = prof
    log(f"[profile] {label} under torch.profiler: wall_s={wall:.3f} "
        f"device_busy_s={busy:.3f} device_events={events} "
        f"{kernel_id.lower()}_device_s={mine:.3f} "
        f"{kernel_id.lower()}_share_of_busy="
        f"{mine / busy if busy else 'not measured'} idle_share="
        f"{1 - busy / wall if busy else 'not measured'} top="
        + json.dumps([[k[:60], round(v, 6)] for k, v in top]))


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
    launch = walk_launch(operands, operands[6][:, 0].cpu().numpy(),
                         operands[7][:, 0].cpu().numpy(), len(ti), tm)

    def k1():
        return lfvt_walk.lfvt_walk_live_tiled(ti, *operands, **kw)

    got = k1()
    torch.cuda.synchronize()
    ms = cuda_ms(k1, 10)
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
    runs = lane_runs(flat, operands, ti.cpu().numpy(), tm, kw["max_steps"])
    if not (np.array_equal(runs[3], lanes[:, 2])
            and np.array_equal(runs[4], lanes[:, 3])):
        raise AssertionError(f"K1's run count at t={t} does not walk as the "
                             "kernel did")
    return (got, (ti, *operands), lanes, err, ms,
            ev[0].elapsed_time(ev[1]), launch, runs[0])


def walk_bound(inputs, got, live_ti, lo, hi, lanes):
    """(bound ms, bound_by, bytes, operations) of one walk call (K1 or
    K6): every input read once and every output written once at the HBM
    rate, against the integer work these inputs need on the live tiles
    ``live_ti`` at the int32 rate (per lane step a window compare and a
    step count, per in-window step one count add, per in-window mask
    cell ~4 ops of the predicate)."""
    moved = (sum(x.numel() * x.element_size() for x in inputs)
             + sum(x.numel() * x.element_size() for x in got))
    lo, hi = lo.long(), hi.long()
    tm = got[0].shape[1]
    live_rows = (live_ti.long()[:, None] * tm
                 + torch.arange(tm, device=lo.device)).reshape(-1)
    cells = int((hi[live_rows] - lo[live_rows]).clamp(min=0).sum())
    lane_steps, win_steps = int(lanes[:, 0].sum()), int(lanes[:, 1].sum())
    ops_n = 2 * lane_steps + win_steps + 4 * cells
    byte_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops_n / INT32_OPS_PER_S * 1e3
    return (max(byte_ms, ops_ms), "bytes" if byte_ms >= ops_ms
            else "operations", moved, ops_n)


def tiled_operands(R, Ss, rows, t, family, tiles, dev, s_bm):
    """K2-K5's operands for the R rows ``rows`` against all of ``Ss`` at
    ``t``, padded as the dispatch pads them -> (operands, skip, live
    tiles, tiles, in-window cells)."""
    from repro_torch.core.tile_join import window_bounds
    from repro_torch.kernels import bitmap_join, onehot_join, ops
    defaults = (bitmap_join if family == "bitmap"
                else onehot_join).DEFAULT_TILES
    W = s_bm.shape[1]
    r_sz = R.sizes()[rows]
    lo, hi = window_bounds(r_sz, Ss.sizes(), t)
    r_bm = torch.tensor(R.bitmaps(W).view(np.int32)[rows], device=dev)
    rb, r_szp, sb, s_szp, lo_p, hi_p, skip, tls, _, _ = ops._prepare(
        r_bm, r_sz, s_bm, Ss.sizes(), lo, hi, tiles, defaults)
    TM, TN, _ = tls
    ti, tj = ops._live_tiles(ops._host_rows(lo, TM), ops._host_rows(hi, TM),
                             rb.shape[0] // TM, sb.shape[0] // TN, TM, TN)
    live = (torch.tensor(ti, device=dev), torch.tensor(tj, device=dev))
    cells = int(np.maximum(hi - lo, 0).sum())
    return (rb, r_szp, sb, s_szp, lo_p, hi_p), skip, live, tls, cells


def tiled_check(kid, args, t, timed, **wrap_kw):
    """Kernel ``kid`` (K2-K5) against its plain version on the card ->
    (kernel outputs, max_abs_err, kernel ms, plain ms, pairs, kernel
    ``queued_ms``); the times only when ``timed``, the last for K2/K3
    only. ``wrap_kw`` goes to the wrapper alone (K2/K3: the compressed S
    the driver passes)."""
    wrap, plain = wrappers()[kid]
    ops_, skip, live, tls, _ = args
    lead = (ops_ + (skip,)) if kid in ("K3", "K5") else (live + ops_)

    def call(fn, **kw):
        out = fn(*lead, t=t, measure="jaccard", tiles=tls, **kw)
        return out if isinstance(out, tuple) else (out,)

    got = call(wrap, **wrap_kw)
    torch.cuda.synchronize()
    ms = cuda_ms(lambda: call(wrap, **wrap_kw), 10) if timed else None
    queued = (queued_ms(lambda: call(wrap, **wrap_kw), 10)
              if timed and kid in ("K2", "K3") else None)
    ev = (torch.cuda.Event(enable_timing=True),
          torch.cuda.Event(enable_timing=True))
    ev[0].record()
    want = call(plain)
    ev[1].record()
    torch.cuda.synchronize()
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{kid} at t={t}: {g.shape}/{g.dtype} vs "
                                 f"plain {w.shape}/{w.dtype}")
        err = max(err, int((g.long() - w.long()).abs().max())
                  if g.numel() else 0)
    if err:
        raise AssertionError(f"{kid} disagrees with its plain version at "
                             f"t={t}: max_abs_err={err}")
    pairs = int(got[0].sum())
    if len(got) > 1 and int(got[1].sum()) != pairs:
        raise AssertionError(f"{kid}'s counts do not sum to its mask")
    return got, err, ms, (ev[0].elapsed_time(ev[1]) if timed else None), \
        pairs, queued


def tiled_bound(kid, args, got, sparse=None):
    """(bound ms, bound_by, bytes, operations) of one K2-K5 call: every
    input read once and every output written once at the HBM rate,
    against the in-window work at the int32 rate (K2/K3: an AND, a POPC
    and an ADD per cell and word) or the int8 tensor-core rate (K4/K5: 2
    operations per cell and universe bit). With ``sparse`` = (the
    compressed S, the in-window cells' words nonzero on both sides) the
    K2/K3 bound of the work these inputs need: the words nonzero on both
    sides only, and S read as its compressed words (the 8-byte pairs
    that exist, not the slabs' padding slots, with the counts and
    offsets); without it, every word of every in-window cell and the
    whole S sheet (the dense figure, which earlier measurements of K2/K3
    used)."""
    ops_, skip, live, _, cells = args
    lead = [skip] if kid in ("K3", "K5") else list(live)
    ins = list(ops_) + lead
    extra = 0
    W = ops_[0].shape[1]
    if kid in ("K2", "K3"):
        ops_n, rate = 3 * cells * W, INT32_OPS_PER_S
        if sparse is not None:
            sp, common = sparse
            ins = [x for k, x in enumerate(ops_) if k != 2] + lead + [
                sp.counts, sp.offsets]
            extra = int(sp.counts.sum()) * 2 * sp.pairs.element_size()
            ops_n = 3 * common
    else:
        ops_n, rate = 2 * cells * 32 * W, INT8_OPS_PER_S
    moved = extra + sum(x.numel() * x.element_size()
                        for x in ins + list(got))
    byte_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops_n / rate * 1e3
    return (max(byte_ms, ops_ms), "bytes" if byte_ms >= ops_ms
            else "operations", moved, ops_n)


def common_words(args) -> int:
    """Sum over the in-window cells of a K2/K3 call of the words nonzero
    in both the row and the column: one float32 product of the 0/1
    nonzero-word matrices, masked by the windows (exact: every entry is
    at most W < 2^24, and TF32 is held off for it)."""
    ops_ = args[0]
    rb, sb, lo, hi = ops_[0], ops_[2], ops_[4], ops_[5]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        both = (rb != 0).float() @ (sb != 0).float().T
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    cols = torch.arange(sb.shape[0], device=rb.device)[None, :]
    both *= (cols >= lo) & (cols < hi)
    out = int(both.sum(dtype=torch.float64))
    del both
    torch.cuda.empty_cache()
    return out


def bitmap_work(args, sp) -> dict:
    """What K2/K3's schedule does on these operands (the live tiles'
    groups, as ``bitmap_join.window_order`` and ``GROUP_ROWS`` cut them):
    the cells its groups' window spans cover, the (column, pair) visits
    (a column's pairs once per union slice), the union lengths and the
    groups whose union takes more than one shared-memory slice."""
    from repro_torch.kernels import bitmap_join
    ops_, _, (ti, tj), (TM, TN, _), cells = args
    rb, lo, hi = ops_[0], ops_[4][:, 0].long(), ops_[5][:, 0].long()
    g_rows = bitmap_join.GROUP_ROWS
    order = bitmap_join.window_order(lo, hi, TM).long()
    groups = -(-TM // g_rows)
    # (tile rows, groups, 16) positions in the order; those past the
    # tile's TM rows are not valid (read as position 0, then masked)
    k = torch.arange(groups * g_rows, device=rb.device)
    pos = (torch.arange(rb.shape[0] // TM, device=rb.device)[:, None] * TM
           + k[None, :]).reshape(-1, groups, g_rows)
    valid = (k < TM).reshape(groups, g_rows)[None]
    rows = order[torch.where(valid, pos, 0)]
    full = valid & (lo[rows] < hi[rows])
    g_lo = torch.where(full, lo[rows], 2 ** 40).amin(-1)
    g_hi = torch.where(full, hi[rows], -1).amax(-1)
    size = valid.sum(-1)
    union = torch.stack([((rb[rows[i]] != 0) & valid[0, :, :, None])
                         .any(1).sum(-1) for i in range(rows.shape[0])])
    c_lo = torch.maximum(g_lo[ti.long()], tj.long()[:, None] * TN)
    c_hi = torch.minimum(g_hi[ti.long()], (tj.long()[:, None] + 1) * TN)
    span = (c_hi - c_lo).clamp(min=0)
    cum = torch.cat([torch.zeros(1, dtype=torch.long, device=rb.device),
                     torch.cumsum(sp.counts.long(), 0)])
    pairs = torch.where(span > 0, cum[c_hi.clamp(min=0)]
                        - cum[c_lo.clamp(max=cum.shape[0] - 1)], 0)
    slices = -(-union[ti.long()] // bitmap_join.UNION_SLICE)
    return {"ctas": int(ti.shape[0] * groups),
            "ctas_with_work": int((span > 0).sum()),
            "in_window_cells": cells,
            "covered_cells": int((span * size).sum()),
            "pair_visits": int((pairs * slices).sum()),
            "union_mean": round(float(union.float().mean()), 3),
            "union_max": int(union.max()),
            "groups_over_one_slice": int((union > bitmap_join.UNION_SLICE)
                                         .sum())}


def membership_matmul_ms(r_bm, s_bm):
    """ms of one bf16 ``torch.matmul`` of the unpacked (rows, 32W)
    membership matrices of ``r_bm`` and ``s_bm`` (the product alone: no
    predicate, no window, a bf16 result)."""
    from repro_torch.kernels.onehot_join import _membership

    def unpack(x):
        out = torch.empty((x.shape[0], 32 * x.shape[1]),
                          dtype=torch.bfloat16, device=x.device)
        for w0 in range(0, x.shape[1], 64):
            out[:, 32 * w0:32 * (w0 + 64)] = _membership(
                x[:, w0:w0 + 64], torch.bfloat16)
        return out

    br, bs = unpack(r_bm), unpack(s_bm)
    ms = cuda_ms(lambda: torch.matmul(br, bs.T), 3)
    del br, bs
    torch.cuda.empty_cache()
    return ms


def onehot_work(args):
    """(live cells, stage products, live stage-tiles) of a K4/K5 call: the
    cells of its live tiles, and how many of their 128-bit stages (4
    words) hold a set word on both the R side and the S side, which is
    what the kernel expands and multiplies, of all the live tiles'
    stages."""
    ops_, _, (ti, tj), (TM, TN, _), _ = args

    def stage_any(bm, rows):
        pad = -bm.shape[1] % 4
        x = torch.nn.functional.pad(bm, (0, pad)) if pad else bm
        return (x.view(x.shape[0] // rows, rows, -1, 4) != 0).any(
            dim=3).any(dim=1)

    r_nz, s_nz = stage_any(ops_[0], TM), stage_any(ops_[2], TN)
    products = int((r_nz[ti.long()] & s_nz[tj.long()]).sum())
    return len(ti) * TM * TN, products, len(ti) * r_nz.shape[1]


def pad_sheet_check(R, Ss, rows, s_bm, sp, dev) -> None:
    """One R block's ``ops.bitmap_join`` (K3's dispatch: the block's
    padding, its skip mask, K3) with the S sheet unpadded (the dispatch
    then pads a copy of it per block) and as the join driver keeps it
    (``ops.pad_sheet``: a view), timed in turns (unpadded, padded,
    padded, unpadded) on the card; equal masks."""
    from repro_torch.core.tile_join import window_bounds
    from repro_torch.kernels import ops
    W = s_bm.shape[1]
    r_bm = torch.tensor(R.bitmaps(W).view(np.int32)[rows], device=dev)
    r_sz = R.sizes()[rows]
    lo, hi = window_bounds(r_sz, Ss.sizes(), MAIN_T)
    s_sz = torch.tensor(Ss.sizes(), dtype=torch.int32, device=dev)
    padded = ops.pad_sheet(s_bm)

    def call(sheet):
        return ops.bitmap_join(r_bm, r_sz, sheet, s_sz, lo, hi, MAIN_T,
                               s_sparse=sp)

    if not torch.equal(call(s_bm), call(padded)):
        raise AssertionError("the padded sheet gives another mask")
    ms = {"unpadded": [], "padded": []}
    for name in ("unpadded", "padded", "padded", "unpadded"):
        ms[name].append(cuda_ms(lambda: call(
            s_bm if name == "unpadded" else padded), 5))
    log(f"[pad] ops.bitmap_join on the block, S sheet unpadded (a copy "
        f"per block) ms={ms['unpadded']} pre-padded (a view) "
        f"ms={ms['padded']} sheet_bytes={padded.numel() * 4}")
    del padded
    torch.cuda.empty_cache()


def dense_case(dev):
    """K2/K3 on dense words: the measures phase's kosarak data (universe
    3 600, W = 113, sets up to 2 497 elements), its first 1024 R rows
    against the size-sorted S at t = 0.5, bit-equal to the plain
    versions and timed beside the bounds -> {kid: (ms, queued ms, plain
    ms, bound, dense bound, pairs)}, the work counts."""
    from repro_torch.kernels import bitmap_join
    R, S = measures_data("kosarak")
    Ss = S.sort_by_size()
    W = max((max(R.universe, Ss.universe) + 31) // 32, 1)
    s_bm = torch.tensor(Ss.bitmaps(W).view(np.int32), device=dev)
    args = tiled_operands(R, Ss, slice(0, BLOCK_ROWS), WIDE_T, "bitmap",
                          None, dev, s_bm)
    sp = bitmap_join.compress_s(args[0][2])
    common = common_words(args)
    out = {}
    for kid in ("K2", "K3"):
        got, _, ms, plain_ms, pairs, queued = tiled_check(
            kid, args, WIDE_T, True, s_sparse=sp)
        out[kid] = (ms, queued, plain_ms,
                    tiled_bound(kid, args, got, (sp, common)),
                    tiled_bound(kid, args, got), pairs)
    work = bitmap_work(args, sp)
    work["s_pairs_per_column"] = round(
        float(sp.counts.float().sum()) / len(Ss), 3)
    return out, work


def small_tile_case(dev):
    """K2-K5 against their plain versions at m = 20, n = 300, W = 3 with
    (32, 128, 2) tiles -> the pairs each found (K2/K3 build their
    compressed S in the wrapper here)."""
    from repro_torch.core.sets import SetCollection
    rng = np.random.default_rng(3)
    r = [rng.choice(96, size=int(rng.integers(1, 30)), replace=False)
         for _ in range(20)]
    s = r[:8] + [rng.choice(96, size=int(rng.integers(1, 30)),
                            replace=False) for _ in range(292)]
    R = SetCollection.from_ragged(r, universe=96)
    Ss = SetCollection.from_ragged(s, universe=96).sort_by_size()
    s_bm = torch.tensor(Ss.bitmaps(3).view(np.int32), device=dev)
    found = {}
    for family, kids in (("bitmap", ("K2", "K3")), ("onehot", ("K4", "K5"))):
        args = tiled_operands(R, Ss, slice(0, 20), 0.5, family, (32, 128, 2),
                              dev, s_bm)
        for kid in kids:
            found[kid] = tiled_check(kid, args, 0.5, False)[4]
    if min(found.values()) <= 0:
        raise AssertionError(f"the small-tile case found no pair: {found}")
    return found


def serve_streams(R, S):
    """Stream A (half exact copies of corpus sets, half livej R sets, in
    a random order) and stream C (A's first three quarters of
    ``ADMIT_REQUESTS`` plus a quarter repeats of earlier requests, each
    inserted at a random later place), from seeds 0 and 1."""
    rng = np.random.default_rng(0)
    half = SERVE_REQUESTS // 2
    reqs = ([S.sets[i] for i in rng.choice(len(S), half, replace=False)]
            + [R.sets[i] for i in rng.choice(len(R), half, replace=False)])
    reqs = [reqs[i] for i in rng.permutation(len(reqs))]
    rng = np.random.default_rng(1)
    admit = list(reqs[:ADMIT_REQUESTS * 3 // 4])
    for _ in range(ADMIT_REQUESTS // 4):
        src = int(rng.integers(0, len(admit)))
        admit.insert(int(rng.integers(src + 1, len(admit) + 1)), admit[src])
    return reqs, admit


def result_key(r):
    """Every field of a DedupResult but its latency."""
    return (r.rid, r.is_dup, r.matches, r.admitted, r.corpus_id,
            sorted(r.stats.items()))


def serve_stream(corpus, reqs, *, schedule, micro_batch=None,
                 admit="none"):
    """Serve ``reqs`` through a new ``DedupServeEngine`` on the card ->
    (engine, results, launches, wall s, construction s, seconds spent
    in admission appends)."""
    import repro_torch
    t0 = time.perf_counter()
    eng = repro_torch.DedupServeEngine(corpus, threshold=MAIN_T, admit=admit,
                                       micro_batch=micro_batch,
                                       schedule=schedule)
    build_s = time.perf_counter() - t0
    appends = []
    append = eng.encoder.append

    def timed_append(sets):
        t1 = time.perf_counter()
        out = append(sets)
        appends.append(time.perf_counter() - t1)
        return out

    eng.encoder.append = timed_append

    def run():
        for r in reqs:
            eng.submit(r)
        return eng.drain()

    t0 = time.perf_counter()
    res, launches = counted(run)
    return (eng, res, launches, time.perf_counter() - t0, build_s,
            sum(appends))


def latency_line(res, wall):
    lat = np.asarray([r.latency_s for r in res])
    p50, p99 = np.percentile(lat, [50, 99])
    return (f"wall_s={wall:.3f} requests_per_s={len(res) / wall:.1f} "
            f"p50_latency_s={p50:.4f} p99_latency_s={p99:.4f}")


def pad_sets(sets, rows=None):
    """Requests padded as the engine pads a micro-batch: a (rows, lane)
    -1-padded int32 block, lane a power-of-two multiple of the lane
    grain -> (block, sizes)."""
    from repro_torch import global_config
    rows = rows or len(sets)
    lane = global_config.serve_lane_grain
    while lane < max(len(a) for a in sets):
        lane <<= 1
    r_pad = np.full((rows, lane), -1, np.int32)
    sizes = np.zeros(rows, np.int64)
    for i, a in enumerate(sets):
        r_pad[i, :len(a)] = a
        sizes[i] = len(a)
    return r_pad, sizes


def walk_block(enc, sets, dev, rows=None):
    """The walk's device-schedule operands for ``sets`` padded into one
    micro-batch of ``rows`` rows as the engine pads it -> (ti_sorted,
    n_live, operands, row_map, static arguments)."""
    from repro_torch import global_config
    from repro_torch.core.device import upload
    from repro_torch.kernels import ops
    r_pad, sizes = pad_sets(sets, rows)
    lo, hi = enc.window_bounds(sizes, MAIN_T)
    tm = global_config.row_tile
    (ti_sorted, n_live), operands, row_map = ops.walk_operands(
        enc.flat, upload(r_pad, dev), sizes, lo, hi, tm, schedule="device")
    kw = dict(t=MAIN_T, measure="jaccard",
              max_steps=int(enc.flat.max_seq_len), tm=tm)
    return ti_sorted, n_live, list(operands), row_map, kw


def k6_check(label, ti_sorted, n_live, operands, kw, plain=True):
    """K6 against K1 on the live tiles, zeros elsewhere, and (``plain``)
    against its plain version -> (K6's outputs, max_abs_err, plain ms or
    None, live tiles)."""
    from repro_torch.kernels import lfvt_walk
    got = lfvt_walk.lfvt_walk_planned(ti_sorted, n_live, *operands, **kw)
    torch.cuda.synchronize()
    err, plain_ms = 0, None
    if plain:
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        want = lfvt_walk.lfvt_walk_planned_ref(ti_sorted, n_live, *operands,
                                               **kw)
        ev[1].record()
        torch.cuda.synchronize()
        plain_ms = ev[0].elapsed_time(ev[1])
        for name, g, w in zip(("masks", "counts", "walk_steps",
                               "early_stops"), got, want):
            if g.shape != w.shape or g.dtype != w.dtype:
                raise AssertionError(f"K6 {name} ({label}): {g.shape}/"
                                     f"{g.dtype} vs plain {w.shape}/{w.dtype}")
            err = max(err, int((g.long() - w.long()).abs().max()))
        if err:
            raise AssertionError(f"K6 disagrees with its plain version "
                                 f"({label}): max_abs_err={err}")
    nl = int(n_live)
    live = ti_sorted[:nl].contiguous()
    k1 = lfvt_walk.lfvt_walk_live_tiled(live, *operands, **kw)
    dead = ti_sorted[nl:].long()
    for name, g, w in zip(("masks", "counts", "walk_steps", "early_stops"),
                          got, k1):
        if not torch.equal(g[live.long()], w) or g[dead].any():
            raise AssertionError(f"K6 {name} ({label}) is not K1's on the "
                                 "live tiles and zero on the dead ones")
    return got, err, plain_ms, live


def serve_phase(R, Ss, runs, dev):
    """The dedup service on the card -> K6's kernels-line entry."""
    import repro_torch
    from repro_torch.core.device import upload
    from repro_torch.core.sets import SetCollection
    from repro_torch.kernels import lfvt_walk, ops
    reqs, admit_reqs = serve_streams(R, Ss)
    torch.cuda.reset_peak_memory_stats()

    # ---- stream A: admit="none", both schedules ---------------------- #
    streams = {}
    for schedule in ("device", "host"):
        eng, res, runs[f"serve_{schedule}"], wall, build_s, _ = serve_stream(
            Ss, reqs, schedule=schedule, micro_batch=SERVE_BATCH)
        streams[schedule] = (eng, res)
        st = eng.stats
        log(f"[serve A] schedule={schedule} requests={len(reqs)} "
            f"micro_batch={SERVE_BATCH} batches={st['batches']} "
            f"{latency_line(res, wall)} engine_build_s={build_s:.3f} "
            f"dups={st['dups']} pair_count={st['pair_count']} "
            f"live_tiles={st['live_tiles']} walk_steps={st['walk_steps']} "
            f"early_stops={st['early_stops']} "
            f"launches={runs[f'serve_{schedule}']}")
    eng_a, res_a = streams["device"]
    if ([result_key(r) for r in res_a]
            != [result_key(r) for r in streams["host"][1]]):
        raise AssertionError("stream A: schedule='device' and 'host' gave "
                             "different results")
    n_batches = -(-len(reqs) // SERVE_BATCH)
    if (runs["serve_device"]["K6"] != n_batches
            or runs["serve_device"]["K1"]):
        raise AssertionError(f"stream A under schedule='device' launched "
                             f"{runs['serve_device']}, not K6 once per "
                             f"batch ({n_batches})")
    if runs["serve_host"]["K6"] or runs["serve_host"]["K1"] <= 0:
        raise AssertionError("stream A under schedule='host' did not run "
                             f"K1 alone: {runs['serve_host']}")
    Rq = SetCollection.from_ragged(reqs, universe=Ss.universe)
    t0 = time.perf_counter()
    joined = repro_torch.join(Rq, Ss, MAIN_T, method="lfvt")
    join_s = time.perf_counter() - t0
    want = [[] for _ in reqs]
    for r, s in joined.pairs:
        want[r].append(s)
    bad = [i for i, r in enumerate(res_a)
           if r.matches != tuple(sorted(want[i]))]
    if bad:
        raise AssertionError(f"stream A: {len(bad)} requests differ from "
                             f"repro_torch.join's pairs, first {bad[:5]}")
    log(f"[serve A] device == host == repro_torch.join(R_req, corpus, "
        f"{MAIN_T}, method='lfvt') for all {len(reqs)} requests: "
        f"pairs={len(joined.pairs)} join_wall_s={join_s:.3f} "
        f"max_memory_allocated={torch.cuda.max_memory_allocated()}")
    # a warm second pass on the same engine, under the profiler
    for r in reqs:
        eng_a.submit(r)
    log_profile("warm stream A (schedule='device')", device_profile(
        eng_a.drain, ("lfvt_walk_planned_kernel",)), "K6")

    # ---- stream B: the defaults a user who sets nothing gets ------- #
    eng_b, res_b, launches_b, wall_b, _, _ = serve_stream(
        Ss, reqs[:SERVE_DEFAULT_REQUESTS], schedule="device")
    if ([(r.is_dup, r.matches) for r in res_b]
            != [(r.is_dup, r.matches) for r in res_a[:len(res_b)]]):
        raise AssertionError("stream B differs from stream A's requests")
    log(f"[serve B] schedule=device requests={len(res_b)} micro_batch="
        f"{eng_b.micro_batch} (default) batches={eng_b.stats['batches']} "
        f"{latency_line(res_b, wall_b)} launches={launches_b}")

    # ---- stream C: admit="survivors", both schedules --------------- #
    streams = {}
    for schedule in ("device", "host"):
        eng, res, launches, wall, build_s, append_s = serve_stream(
            Ss, admit_reqs, schedule=schedule, micro_batch=SERVE_BATCH,
            admit="survivors")
        streams[schedule] = (eng, res)
        st, es = eng.stats, eng.encoder.stats
        log(f"[serve C] schedule={schedule} requests={len(admit_reqs)} "
            f"{latency_line(res, wall)} admission_append_s={append_s:.3f} "
            f"dups={st['dups']} admitted={st['admitted']} "
            f"intra_batch_dups={st['intra_batch_dups']} corpus_rows="
            f"{eng.corpus_rows} append_work={eng.encoder.append_work} "
            f"merged_chains={es['merged_chains']} prepend_fast_path="
            f"{es['prepend_fast_path']} regrows={es['regrows']} "
            f"seq_slots={eng.encoder.t_live} launches={launches}")
    eng_c, res_c = streams["device"]
    if ([result_key(r) for r in res_c]
            != [result_key(r) for r in streams["host"][1]]):
        raise AssertionError("stream C: schedule='device' and 'host' gave "
                             "different results")
    batch_of = {r.corpus_id: r.rid // SERVE_BATCH for r in res_c
                if r.admitted}
    cross = sum(any(batch_of.get(m, len(res_c)) < r.rid // SERVE_BATCH
                    for m in r.matches) for r in res_c)
    if eng_c.stats["intra_batch_dups"] <= 0 or cross <= 0:
        raise AssertionError(f"stream C: intra-batch dups "
                             f"{eng_c.stats['intra_batch_dups']}, cross-batch "
                             f"dups {cross}; both must occur")
    enc = eng_c.encoder
    probe = admit_reqs[:SERVE_BATCH]

    def probe_pairs():
        r_pad, r_sz = pad_sets(probe)
        lo, hi = enc.window_bounds(r_sz, MAIN_T)
        pending = ops.lfvt_walk_join_pairs_dispatch(
            enc.flat, upload(r_pad, dev), r_sz, lo, hi, MAIN_T,
            schedule="device")
        pairs, n = ops.join_pairs_finalize(pending)
        return {(int(r), int(enc.flat.s_ids[c]))
                for r, c in pairs[:n].cpu().numpy()}

    # K6 and K1 on the grown table (appended tail rows, re-encoded
    # chains), against their plain versions
    ti_g, nl_g, ops_g, _, kw_g = walk_block(enc, probe, dev)
    k6_check("grown corpus", ti_g, nl_g, ops_g, kw_g)
    f = enc.flat
    q = np.arange(enc.t_live)
    nxt = f.seq_next[:enc.t_live]
    hop = nxt >= 0
    raised = int((f.seq_row[nxt[hop]] >= f.seq_row[q[hop]]).sum())
    log(f"[kernel K6] grown corpus (stream C, before compact): "
        f"rows={SERVE_BATCH} live_tiles={int(nl_g)}/{ti_g.shape[0]} "
        f"seq_slots={enc.t_live} hops={int(hop.sum())} "
        f"hops_not_lowering_the_row={raised} merged_chains="
        f"{enc.stats['merged_chains']}: K6 vs plain and K1 vs K6 on the live "
        "tiles bit-equal (K1 equals its plain version there)")
    before = probe_pairs()
    t0 = time.perf_counter()
    enc.compact()
    compact_s = time.perf_counter() - t0
    after = probe_pairs()
    if before != after or not before:
        raise AssertionError(f"stream C: the probe's {len(before)} pairs on "
                             f"the grown view are not its {len(after)} on "
                             "the compacted one")
    log(f"[serve C] device == host; cross_batch_dups={cross}; compact_s="
        f"{compact_s:.3f} corpus_rows={enc.n_live}; a {len(probe)}-row "
        f"probe gives the same {len(before)} pairs on the grown and the "
        "compacted corpus")

    # ---- K6 against its plain version and K1 ------------------------ #
    part = reqs[-PARTIAL_REQUESTS:]
    ti_s, nl, operands, row_map, kw = walk_block(eng_a.encoder, part, dev,
                                                 SERVE_BATCH)
    m_tiles = ti_s.shape[0]
    if not 0 < int(nl) < m_tiles:
        raise AssertionError(f"the partial batch has {int(nl)} live of "
                             f"{m_tiles} tiles; its padding should be dead")
    got, err, plain_ms, live = k6_check("partial batch", ti_s, nl, operands,
                                        kw)
    # the whole device-schedule dispatch, as the engine makes it for this
    # batch (the corpus is on the card already), never waits for the card
    r_pad, r_sz = pad_sets(part, SERVE_BATCH)
    lo, hi = eng_a.encoder.window_bounds(r_sz, MAIN_T)
    eng_a.encoder.flat.to_device(dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = ops.lfvt_walk_join_pairs_dispatch(
            eng_a.encoder.flat, upload(r_pad, dev), r_sz, lo, hi, MAIN_T,
            schedule="device")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if ops.join_pairs_finalize(pending)[1] != int(got[1].sum()):
        raise AssertionError("the dispatch under sync debug mode gave "
                             "another pair count than K6 on its operands")
    crafted = list(operands)
    hi_c = crafted[7].clone()
    for k in range(0, m_tiles, 2):  # tile 0 dies: not the identity
        hi_c[k * kw["tm"]:(k + 1) * kw["tm"]] = crafted[6][
            k * kw["tm"]:(k + 1) * kw["tm"]]
    crafted[7] = hi_c
    ti_c, nl_c = lfvt_walk.plan_row_tiles_device(crafted[6], hi_c, kw["tm"])
    if torch.equal(ti_c.cpu(), torch.arange(m_tiles, dtype=torch.int32)):
        raise AssertionError("the crafted plan is the identity")
    # a non-identity plan: K6 against K1 on the live tiles is enough here
    k6_check("crafted", ti_c, nl_c, crafted, kw, plain=False)
    ms = cuda_ms(lambda: lfvt_walk.lfvt_walk_planned(ti_s, nl, *operands,
                                                     **kw), 10)
    k1_ms = cuda_ms(lambda: lfvt_walk.lfvt_walk_live_tiled(live, *operands,
                                                           **kw), 10)
    # the same operands with 8 parked lanes appended: identical outputs,
    # and a CTA skips parked lanes past its row's last live one
    wide = list(operands)
    for k in (0, 1):
        wide[k] = torch.nn.functional.pad(operands[k], (0, 8))
    got_w = lfvt_walk.lfvt_walk_planned(ti_s, nl, *wide, **kw)
    if not all(torch.equal(a, b) for a, b in zip(got, got_w)):
        raise AssertionError("K6 with 8 parked lanes appended differs")
    wide_ms = cuda_ms(lambda: lfvt_walk.lfvt_walk_planned(ti_s, nl, *wide,
                                                          **kw), 10)
    order = row_map.cpu().numpy()
    rows_sets = part + [np.zeros(0, np.int32)] * (SERVE_BATCH - len(part))
    lanes = lane_counts(Ss, rows_sets, order[order >= 0],
                        operands[6][:, 0].cpu().numpy(),
                        operands[7][:, 0].cpu().numpy(), live.cpu().numpy(),
                        kw["tm"])
    live_l = live.long()
    if not (np.array_equal(lanes[:, 2], got[2][live_l, 0].cpu().numpy())
            and np.array_equal(lanes[:, 3],
                               got[3][live_l, 0].cpu().numpy())):
        raise AssertionError("K6 walk_steps/early_stops disagree with the "
                             "numpy lane count")
    runs = lane_runs(eng_a.encoder.flat, operands, live.cpu().numpy(),
                     kw["tm"], kw["max_steps"])
    if not (np.array_equal(runs[3], lanes[:, 2])
            and np.array_equal(runs[4], lanes[:, 3])):
        raise AssertionError("K6's run count does not walk as the kernel "
                             "did")
    launch = walk_launch(operands, operands[6][:, 0].cpu().numpy(),
                         operands[7][:, 0].cpu().numpy(), m_tiles, kw["tm"])
    bound_ms, bound_by, moved, ops_n = walk_bound(
        [ti_s, nl, *operands], got, live, operands[6], operands[7], lanes)
    log(f"[kernel K6] partial batch of A: requests={len(part)} rows="
        f"{SERVE_BATCH} live_tiles={int(nl)}/{m_tiles} Lr="
        f"{operands[0].shape[1]} NP={operands[4].shape[1]} pairs="
        f"{int(got[1].sum())} walk_steps={int(got[2].sum())} lane_steps="
        f"{int(lanes[:, 0].sum())} runs_per_lane_mean={runs[0].mean():.3f} "
        f"runs_per_lane_max={int(runs[0].max())} ctas={launch[0]} "
        f"widest_window={launch[4]} smem_cols={launch[1]} "
        f"dynamic_smem_bytes={launch[2]} column_passes_max={launch[3]} "
        f"K6 vs plain "
        f"and vs K1 bit-equal; crafted copy live_tiles={int(nl_c)}/{m_tiles}"
        f" bit-equal to K1 there; lfvt_walk_join_pairs_dispatch("
        f"schedule='device') ran under set_sync_debug_mode('error'); "
        f"ms={ms:.4f} k1_ms={k1_ms:.4f} ms_lanes_plus8={wide_ms:.4f} "
        f"plain_ms={plain_ms:.1f} "
        f"bound_ms={bound_ms:.6f} bound_by={bound_by} bytes={moved} "
        f"int32_ops={ops_n} k6_over_bound={ms / bound_ms:.1f}")
    full = walk_block(eng_a.encoder, reqs[:SERVE_BATCH], dev)
    f_live = full[0][:int(full[1])].contiguous()
    f_ms = cuda_ms(lambda: lfvt_walk.lfvt_walk_planned(
        full[0], full[1], *full[2], **full[4]), 10)
    f_k1 = cuda_ms(lambda: lfvt_walk.lfvt_walk_live_tiled(
        f_live, *full[2], **full[4]), 10)
    log(f"[kernel K6] full batch 0 of A: live_tiles={int(full[1])}/"
        f"{full[0].shape[0]} ms={f_ms:.4f} k1_ms={f_k1:.4f}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                library_note="no single PyTorch call computes the walk "
                             "with its counters",
                check="bit-equal to its plain version and to K1 on the "
                      "live tiles, zeros elsewhere, on stream A's last "
                      "requests as a partial batch; bit-equal to K1 and "
                      "zeros on a copy with every other tile's windows "
                      "emptied; bit-equal to its plain version and to K1 "
                      "on a corpus grown by admission")


def condition_attention(params, dims, d_model) -> None:
    """Rescale the seeded attention projections in place to 1/sqrt of the
    width they contract. The reference's init rule takes fan_in =
    shape[-2], which for the 4-D projections is the head axis (12 for
    wq, 2 for wk and wv) or head_dim (wo), not d_model or H*D: scores
    then have a standard deviation of ~300, every softmax is an argmax,
    and any rounding difference (bf16, or float32 summation order) flips
    argmaxes and compounds through the 28 layers. Real checkpoints are
    not built that way."""
    a = params["blocks"]["attn"]["attn"]
    for name, fan_in in (("wq", dims.n_heads_p), ("wk", dims.n_kv),
                         ("wv", dims.n_kv)):
        a[name].mul_((fan_in / d_model) ** 0.5)
    a["wo"].mul_((1 / dims.n_heads_p) ** 0.5)


class GapRecorder:
    """A model for ``ServeEngine`` (duck-typed): runs ``model`` and keeps,
    per step and stream, the top-2 gap and the largest |logit|."""

    def __init__(self, model):
        self.model, self.gaps, self.scale = model, [], []

    def _note(self, logits):
        last = logits[:, -1].float()
        top2 = last.topk(2, dim=-1).values
        self.gaps.append((top2[:, 0] - top2[:, 1]).cpu().numpy())
        self.scale.append(last.abs().amax(dim=-1).cpu().numpy())

    def prefill(self, *args, **kw):
        out = self.model.prefill(*args, **kw)
        self._note(out[0])
        return out

    def decode_step(self, *args, **kw):
        out = self.model.decode_step(*args, **kw)
        self._note(out[0])
        return out


def llm_phase(runs, dev):
    """LLM serving on the card: qwen2-1.5b (28 layers, full width, bf16,
    seeded weights) through ``repro_torch.ServeEngine`` with
    ``attn_impl="flash"``, held against an ``attn_impl="jnp"`` build; the
    counted prefill's launches go to ``runs["llm_prefill"]``."""
    import dataclasses

    import repro_torch
    from repro_torch.models.params import init_params, tree_leaves
    cfg = dataclasses.replace(repro_torch.get_config(LLM_ARCH),
                              attn_impl="flash")
    model = repro_torch.build_model(cfg)
    plain = repro_torch.build_model(dataclasses.replace(cfg,
                                                        attn_impl="jnp"))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(model.param_specs(),
                         torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (LLM_BATCH, LLM_PROMPT)).astype(np.int32)
    toks = torch.from_numpy(prompts).to(dev)
    # as drawn by the reference's init rule the two builds disagree (see
    # condition_attention); logged, not held
    raw_rel = last_logits_rel_l2(model, plain, params, toks)
    condition_attention(params, model.dims, cfg.d_model)
    n_params = sum(x.numel() for x in tree_leaves(params))
    log(f"[llm] {cfg.name} layers={cfg.n_layers} d_model={cfg.d_model} "
        f"heads={cfg.n_heads} kv_heads={cfg.n_kv_heads} head_dim="
        f"{model.dims.head_dim} d_ff={cfg.d_ff} vocab={cfg.vocab_size} "
        f"params={n_params} weight_bytes={2 * n_params} (bf16) "
        f"init_s={init_s:.3f} attn_impl=flash; before condition_attention "
        f"the flash and plain builds' last-token logits differ by "
        f"rel_l2={raw_rel:.3f}")
    eng = repro_torch.ServeEngine(model, params, max_seq_len=LLM_CACHE)
    t0 = time.perf_counter()
    eng.generate(prompts, 1)
    cold_s = time.perf_counter() - t0
    # the main-path run of K7: one prefill (and its first token)
    t0 = time.perf_counter()
    first, runs["llm_prefill"] = counted(lambda: eng.generate(prompts, 1))
    prefill_s = time.perf_counter() - t0
    if runs["llm_prefill"]["K7"] != cfg.n_layers:
        raise AssertionError(f"the prefill launched K7 "
                             f"{runs['llm_prefill']['K7']} times, not once "
                             f"per layer ({cfg.n_layers})")
    t0 = time.perf_counter()
    out, gen_runs = counted(lambda: eng.generate(prompts, LLM_NEW))
    gen_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    decode_s = gen_s - prefill_s
    if (out.shape != (LLM_BATCH, LLM_NEW) or out.min() < 0
            or out.max() >= cfg.vocab_size
            or not np.array_equal(out[:, :1], first)
            or gen_runs["K7"] != cfg.n_layers):
        raise AssertionError(f"generate gave {out.shape} tokens in "
                             f"[{out.min()}, {out.max()}], K7 launches "
                             f"{gen_runs['K7']}")
    cache_bytes = (2 * cfg.n_layers * LLM_BATCH * LLM_CACHE
                   * cfg.n_kv_heads * model.dims.head_dim * 2)
    log(f"[llm] serve: prompts={LLM_BATCH}x{LLM_PROMPT} new_tokens="
        f"{LLM_NEW} max_seq_len={LLM_CACHE} cold_prefill_s={cold_s:.3f} "
        f"prefill_s={prefill_s:.4f} prefill_tokens_per_s="
        f"{LLM_BATCH * LLM_PROMPT / prefill_s:.0f} generate_s={gen_s:.3f} "
        f"decode_s={decode_s:.3f} decode_ms_per_step="
        f"{decode_s / (LLM_NEW - 1) * 1e3:.2f} decode_tokens_per_s="
        f"{LLM_BATCH * (LLM_NEW - 1) / decode_s:.1f} kv_cache_bytes="
        f"{cache_bytes} max_memory_allocated={peak} "
        f"launches={runs['llm_prefill']}")

    # the plain-attention build on the same weights: prefill logits, then
    # greedy tokens compared while its top-2 gap clears the tolerance
    with torch.inference_mode():
        lf = model.prefill(params, toks, LLM_CACHE)[0][:, -1].float()
        lp = plain.prefill(params, toks, LLM_CACHE)[0][:, -1].float()
    if not (torch.isfinite(lf).all() and torch.isfinite(lp).all()):
        raise AssertionError("the prefill logits are not finite")
    err = (lf - lp).abs().amax(dim=-1)
    tol = LLM_LOGIT_TOL * lp.abs().amax(dim=-1)
    rel_l2 = float((lf - lp).norm() / lp.norm())
    if (err > tol).any():
        raise AssertionError(f"flash and plain prefill logits differ by "
                             f"{err.tolist()} (tolerance {tol.tolist()})")
    rec = GapRecorder(plain)
    want = repro_torch.ServeEngine(rec, params, max_seq_len=LLM_CACHE
                                   ).generate(prompts, LLM_NEW)
    gaps = np.stack(rec.gaps, axis=1)
    margin = LLM_LOGIT_TOL * np.stack(rec.scale, axis=1)
    compared = []
    for i in range(LLM_BATCH):
        k = 0
        while k < LLM_NEW and gaps[i, k] > margin[i, k]:
            k += 1
        if not np.array_equal(out[i, :k], want[i, :k]):
            raise AssertionError(f"stream {i}: flash and plain greedy tokens "
                                 f"differ within the first {k} steps")
        compared.append(k)
    log(f"[llm] flash vs plain attention (same weights): last-token "
        f"logits max_abs_err={float(err.max()):.4f} (tolerance "
        f"{LLM_LOGIT_TOL} x max|logit| = {float(tol.min()):.4f}.."
        f"{float(tol.max()):.4f}) max_err_over_max_logit="
        f"{float((err / lp.abs().amax(dim=-1)).max()):.4f} rel_l2="
        f"{rel_l2:.2e}; greedy tokens equal for the steps whose plain "
        f"top-2 gap exceeds the tolerance: "
        f"compared_steps={compared} of {LLM_NEW} per stream; "
        f"streams_equal_in_full="
        f"{int((out == want).all(axis=1).sum())}/{LLM_BATCH}")
    prof = device_profile(lambda: eng.generate(prompts, 1),
                          K7_KERNEL_NAMES)
    log_profile("llm prefill (generate 1 token)", prof, "K7")
    with torch.inference_mode():
        state = model.prefill(params, toks, LLM_CACHE)[1]
        tok = torch.from_numpy(out[:, :1]).to(dev)

        def decode_steps():
            for step in range(DECODE_PROFILED):
                model.decode_step(params, tok, LLM_PROMPT + step, state)
        prof = device_profile(decode_steps, K7_KERNEL_NAMES)
    log_profile(f"llm decode ({DECODE_PROFILED} decode_steps)", prof, "K7")
    log(f"[llm] decode: device_events_per_step="
        f"{prof[4] / DECODE_PROFILED:.0f} host_ms_per_step="
        f"{prof[0] / DECODE_PROFILED * 1e3:.2f} device_busy_ms_per_step="
        f"{prof[1] / DECODE_PROFILED * 1e3:.2f}")
    del eng, params, rec, state
    torch.cuda.empty_cache()


def last_logits_rel_l2(model, plain, params, toks) -> float:
    """Relative L2 distance of the two builds' last-token prefill logits
    (``plain``'s as the reference)."""
    with torch.inference_mode():
        lf = model.prefill(params, toks, LLM_CACHE)[0][:, -1].float()
        lp = plain.prefill(params, toks, LLM_CACHE)[0][:, -1].float()
    return float((lf - lp).norm() / lp.norm())


def k7_pairs(l, window):
    """(q, k) pairs K7's masks keep in one head: sum over q < l of
    min(q + 1, window)."""
    w = l if window is None else min(window, l)
    return w * (w + 1) // 2 + (l - w) * w


def k7_check(label, b, l, h, kv, d, window, dtype, dev):
    """K7 against its plain version on seeded normal q, k, v -> a dict of
    its numbers: error, times, bound, and SDPA's time where the case has
    no window. ``kv`` None: the merged (B*H, L, D) layout through
    ``flash_attention_bhld``; else q (B, L, H, D) and k, v (B, L, KV, D)
    through ``flash_attention_blhd``."""
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device=dev).manual_seed(b * h + l + d)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kw = dict(scale=d ** -0.5, window=window)
    if kv is None:
        q, k, v = (torch.randn((b * h, l, d), generator=g, device=dev)
                   .to(dtype) for _ in range(3))
        kernel, plain = fa.flash_attention_bhld, fa.flash_attention_bhld_ref
        q4, k4, v4 = (x.view(1, b * h, l, d) for x in (q, k, v))
        gqa, kv_heads = False, h
    else:
        q, k, v = (torch.randn((b, l, n, d), generator=g, device=dev)
                   .to(dtype) for n in (h, kv, kv))
        kernel, plain = fa.flash_attention_blhd, fa.flash_attention_blhd_ref
        q4, k4, v4 = (x.transpose(1, 2) for x in (q, k, v))
        gqa, kv_heads = kv != h, kv
    got = kernel(q, k, v, **kw)
    torch.cuda.synchronize()
    ev = (torch.cuda.Event(enable_timing=True),
          torch.cuda.Event(enable_timing=True))
    ev[0].record()
    want = plain(q, k, v, **kw)
    ev[1].record()
    torch.cuda.synchronize()
    tol = K7_TOL[dtype]
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    if got.shape != want.shape or got.dtype != dtype or not bool(
            (diff <= tol + tol * want.float().abs()).all()):
        raise AssertionError(f"K7 ({label}) disagrees with its plain version:"
                             f" max_abs_err={err} (atol = rtol = {tol})")
    out = dict(label=label, max_abs_err=err, plain_ms=ev[0].elapsed_time(
        ev[1]), tol=tol)
    del want, diff
    out["ms"] = cuda_ms(lambda: kernel(q, k, v, **kw), 20)
    out["library_ms"] = (cuda_ms(lambda: sdpa(q4, k4, v4, is_causal=True,
                                              enable_gqa=gqa), 20)
                         if window is None else None)
    # Q and O at H heads, K and V at the heads the kernel reads
    moved = 2 * (h + kv_heads) * b * l * d * q.element_size()
    flops = 4 * b * h * k7_pairs(l, window) * d
    rate = BF16_OPS_PER_S if dtype == torch.bfloat16 else F32_OPS_PER_S
    byte_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / rate * 1e3
    out.update(bound_ms=max(byte_ms, ops_ms), bound_by=(
        "bytes" if byte_ms >= ops_ms else "operations"), bytes=moved,
        flops=flops)
    del q, k, v, got
    torch.cuda.empty_cache()
    return out


def ptxas_registers(log_text: str, names) -> list[str]:
    """Per kernel of ``names`` in an ``nvcc -Xptxas -v`` log: its template
    arguments (from the mangled name: ``Li128E`` is 128, ``Lb1E`` true),
    registers at entry, spill bytes and static shared memory."""
    out, name = [], None
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            name = next((k for k in names if k in line), None)
            if name and f"{name}I" in line:
                args = line.split(f"{name}I", 1)[1].split("EE", 1)[0] + "E"
                vals = [("true" if v == "1" else "false") if kind == "b"
                        else v for kind, v in re.findall(r"L([bi])(\d+)E",
                                                         args)]
                name += "<" + ", ".join(vals) + ">"
        elif name and "spill stores" in line:
            spills = line.strip()
        elif name and "Used" in line and "registers" in line:
            regs = line.split("Used", 1)[1].split("registers")[0].strip()
            smem = re.search(r"(\d+) bytes smem", line)
            out.append(f"{name}: registers={regs} {spills} static_smem="
                       f"{smem.group(1) if smem else 0}")
            name = None
    return out


def onehot_smem_lines() -> list[str]:
    """The dynamic shared memory one K4/K5 CTA asks for, per configuration
    (the library's ``onehot_join_smem_bytes``)."""
    from repro_torch.kernels import _build
    so = _build.load("onehot_join")
    so.onehot_join_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    so.onehot_join_smem_bytes.restype = ctypes.c_int
    return [f"<{cons}, {tn}> (TM {'65-128' if cons == 2 else '1-64'}, "
            f"TN {tn}): dynamic_smem_bytes="
            f"{so.onehot_join_smem_bytes(64 * cons, tn)}"
            for cons in (1, 2) for tn in (128, 256)]


def bitmap_smem_lines() -> list[str]:
    """The dynamic shared memory a K2/K3 join CTA asks for (the library's
    ``bitmap_join_smem_bytes``, which must equal the wrapper's
    ``sparse_smem_bytes``) at the word widths this run meets and the
    widest the kernels take."""
    from repro_torch.kernels import _build, bitmap_join
    so = _build.load("bitmap_join")
    so.bitmap_join_smem_bytes.argtypes = [ctypes.c_int]
    so.bitmap_join_smem_bytes.restype = ctypes.c_int
    out = []
    for words in (4, 120, 1368, bitmap_join.MAX_WORDS):
        got = so.bitmap_join_smem_bytes(words)
        if got != bitmap_join.sparse_smem_bytes(words):
            raise AssertionError(f"K2/K3 shared memory at W={words}: the "
                                 f"library says {got}, the wrapper "
                                 f"{bitmap_join.sparse_smem_bytes(words)}")
        out.append(f"W={words}: dynamic_smem_bytes={got}")
    return out


def measures_configs():
    """Every (dataset, method, measure, threshold, emit) of the measures
    phase."""
    return [(name, method, m, t, e) for name, methods in MEASURE_SETS
            for method in methods for m in MEASURES for t in THRESHOLDS
            for e in ("pairs", "mask")]


def front_door_configs():
    """The measures phase's front-door calls: each measure and emit mode
    once at ``FRONT_DOOR_T``, the four bitmap methods in turn."""
    return [("kosarak", BITMAP_METHODS[k % len(BITMAP_METHODS)], m,
             FRONT_DOOR_T, e)
            for k, (m, e) in enumerate((m, e) for m in MEASURES
                                       for e in ("pairs", "mask"))]


def measures_cuda(configs):
    """The measures phase's card side -> (driver results, front-door
    results, |R| per dataset)."""
    t0 = time.perf_counter()
    data = {name: measures_data(name) for name, _ in MEASURE_SETS}
    out = []
    for cfg in configs:
        out.append(port_join(*data[cfg[0]], *cfg[1:]))
        if cfg[2:] == (MEASURES[-1], THRESHOLDS[-1], "mask"):
            log(f"[measures] cuda {cfg[0]} {cfg[1]} done")
    log(f"[measures] cuda driver side s={time.perf_counter() - t0:.3f}")
    t0 = time.perf_counter()
    fronts = [front_door_join(*data[cfg[0]], *cfg[1:])
              for cfg in front_door_configs()]
    log(f"[measures] cuda front-door calls={len(fronts)} "
        f"s={time.perf_counter() - t0:.3f}")
    return out, fronts, {name: len(data[name][0]) for name in data}


def measures_compare(configs, cuda_out, fronts, sizes, cpu_async) -> None:
    """Hold the card's results (driver and front door) against the CPU
    workers': identical pairs and counters."""
    t0 = time.perf_counter()
    cpu_res = cpu_async.get()
    log(f"[measures] waited for the cpu workers s="
        f"{time.perf_counter() - t0:.3f}")
    per = {}
    for cfg, (_, sec) in zip(configs, cpu_res):
        per[cfg[:2]] = per.get(cfg[:2], 0.0) + sec
    log("[measures] cpu worker seconds per dataset/method: " + json.dumps(
        {f"{k[0]}/{k[1]}": round(v, 1) for k, v in per.items()}))
    for cfg, a, (b, _) in zip(configs, cuda_out, cpu_res):
        if a != b:
            raise AssertionError(f"cuda and cpu differ at {cfg}: {a} vs {b}")
    cpu_of = {cfg: b for cfg, (b, _) in zip(configs, cpu_res)}
    for cfg, a in zip(front_door_configs(), fronts):
        if a != cpu_of[cfg]:
            raise AssertionError(f"the front door on the card and the cpu "
                                 f"driver differ at {cfg}: {a} vs "
                                 f"{cpu_of[cfg]}")
    log(f"[measures] front door == cpu driver at t={FRONT_DOOR_T}: "
        + ", ".join(f"{c[1]}/{c[2]}/{c[4]} pairs={a[0][0]}"
                    for c, a in zip(front_door_configs(), fronts)))
    for name, methods in MEASURE_SETS:
        for method in methods:
            n_pairs = [a[0][0] for c, a in zip(configs, cuda_out)
                       if c[:2] == (name, method) and c[4] == "pairs"]
            log(f"[measures] {name} {method} |R|=|S|={sizes[name]} "
                f"configs={2 * len(n_pairs)} cuda==cpu pairs={n_pairs}")


def mr_measures_cuda(cfgs):
    """The measures phase's MR calls on the card -> their results."""
    t0 = time.perf_counter()
    data = {name: measures_data(name) for name, *_ in MR_SETS}
    out = [mr_join(*data[cfg[0]], cfg) for cfg in cfgs]
    log(f"[measures mr] cuda calls={len(out)} shards={MR_MEASURE_SHARDS} "
        f"s={time.perf_counter() - t0:.3f}")
    return out


def mr_measures_compare(cfgs, cuda_out, mr_async) -> None:
    """Hold the card's MR results against the CPU workers': identical
    pairs and counters (the resilience counters of the managed runs
    included); a managed run may degrade only where its plan injected an
    OOM or a storm, and only from the walk to the whole-block walk."""
    t0 = time.perf_counter()
    cpu_res = mr_async.get()
    log(f"[measures mr] waited for the cpu workers s="
        f"{time.perf_counter() - t0:.3f} cpu worker s="
        f"{sum(sec for _, sec in cpu_res):.1f}")
    for cfg, a, (b, _) in zip(cfgs, cuda_out, cpu_res, strict=True):
        if a != b:
            raise AssertionError(f"MR on the card and the cpu differ at "
                                 f"{cfg}: {a} vs {b}")
        plan = cfg[6]
        if plan is None:
            continue
        st = a[1]
        degrades = "oom" in plan or "storm" in plan
        if (not st["faults_injected"]
                or (degrades and not st["degradations"])
                or any(not d.endswith(":lfvt->lfvt_ref") or not degrades
                       for d in st["degradations"])):
            raise AssertionError(f"managed MR run {cfg}: degradations the "
                                 f"plan did not inject, or none injected: "
                                 f"{st}")
        log(f"[measures mr] managed {cfg[2]} plan={plan!r} pairs={a[0][0]} "
            f"retries={st['retries']} faults_injected="
            f"{st['faults_injected']} degradations={st['degradations']} "
            "(== cpu)")
    for name, methods, *_ in MR_SETS:
        for method in methods:
            got = [(c[2], c[4], a[0][0], a[1]["shard_methods"])
                   for c, a in zip(cfgs, cuda_out)
                   if c[:2] == (name, method) and c[5] == "load_aware"
                   and c[6] is None]
            log(f"[measures mr] {name} {method} load_aware cuda==cpu "
                "(measure, emit, pairs, shard_methods): " + json.dumps(got))
    log("[measures mr] dblp lfvt hash cuda==cpu pairs=" + json.dumps(
        [a[0][0] for c, a in zip(cfgs, cuda_out) if c[5] == "hash"]))


def kill_and_resume(want) -> None:
    """Run the first MR config in a child process on the card, killed
    (SIGKILL) at its 2nd checkpoint write, then resume it in a second
    child: the resumed pairs must equal ``want`` (the card's
    uninterrupted run) with at least one task resumed."""
    import shutil
    ckpt = ROOT / "build" / "mr_kill_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    t0 = time.perf_counter()

    def child(phase):
        return subprocess.run(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--mr-child", phase,
             str(ckpt)], capture_output=True, text=True, timeout=300,
            env=dict(os.environ, REPRO_FAULT=""))

    out = child("kill")
    if out.returncode != -9:
        raise AssertionError(f"the killed child exited {out.returncode}: "
                             f"{out.stderr[-2000:]}")
    saved = sorted(p.name for p in ckpt.glob("task_*.npz"))
    out = child("resume")
    if out.returncode != 0:
        raise AssertionError(f"the resumed child failed: "
                             f"{out.stderr[-2000:]}")
    got = json.loads(out.stdout.strip().splitlines()[-1])
    if tuple(got["digest"]) != tuple(want) or got["tasks_resumed"] < 1:
        raise AssertionError(f"kill and resume: {got} vs {want}")
    shutil.rmtree(ckpt, ignore_errors=True)
    log(f"[measures mr] kill and resume on the card: killed with "
        f"{len(saved)} task(s) saved, resumed {got['tasks_resumed']}, "
        f"pairs={got['digest'][0]} (== uninterrupted) "
        f"s={time.perf_counter() - t0:.3f}")


def mr_live_shards(R, S, t) -> int:
    """Shards of the full-size MR join with a row whose window holds a
    column: each launches K1 once (``method='lfvt'``), K2 at least once
    (``'kernel_bitmap'``)."""
    from repro_torch.core.partition import load_aware_partition, route
    from repro_torch.core.tile_join import window_bounds
    part = load_aware_partition(R, S, t, MR_SHARDS)
    s_rows, r_rows, _ = route(R, S, part)
    live = 0
    for rs, ss in zip(r_rows, s_rows):
        if len(rs) and len(ss):
            lo, hi = window_bounds(R.sizes()[rs],
                                   np.sort(S.sizes()[ss])[::-1], t)
            live += bool(np.any(lo < hi))
    return live


def mr_phase(R, Ss, want, runs) -> None:
    """The MapReduce driver at full size: ``repro_torch.join(R, S, 0.8,
    n_shards=8)`` with ``lfvt`` (cold, warm, profiled), ``auto`` and
    ``kernel_bitmap``; each must give ``want`` (the single-device join's
    pairs) and launch its kernels as counted."""
    import repro_torch
    from repro_torch.core.partition import load_aware_partition, route
    from repro_torch.core.sets import SetCollection
    t0 = time.perf_counter()
    live = mr_live_shards(R, Ss, MAIN_T)
    s_rows, _, _ = route(R, Ss, load_aware_partition(R, Ss, MAIN_T,
                                                     MR_SHARDS))
    route_s = time.perf_counter() - t0
    # the host encode each lfvt call pays: every shard's S as a FlatLFVT
    t0 = time.perf_counter()
    for ss in s_rows:
        SetCollection([Ss.sets[int(j)] for j in ss], Ss.universe,
                      Ss.ids[ss].astype(np.int32)).flat_lfvt()
    encode_s = time.perf_counter() - t0
    log(f"[mr] host set-up per call: partition+route_s={route_s:.3f} "
        f"shard_encode_s={encode_s:.3f} shards_with_live_rows={live}")

    def call(label, **kw):
        st: dict = {}
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out, launches = counted(lambda: repro_torch.join(
            R, Ss, MAIN_T, n_shards=MR_SHARDS, stats=st, **kw))
        wall = time.perf_counter() - t0
        if out.pairs != want:
            raise AssertionError(f"MR {label}: {len(out.pairs)} pairs, the "
                                 f"single-device join {len(want)}")
        log(f"[mr {label}] pairs={len(out.pairs)} (== single-device) "
            f"wall_s={wall:.3f} psi={st['psi']} intervals="
            f"{json.dumps(st['intervals'])} shard_loads="
            f"{json.dumps(st['shard_loads'])} max_load={st['max_load']} "
            f"r_replication={st['r_replication']} shuffle_bytes="
            f"{st['shuffle_bytes']} shard_block_bytes="
            f"{st['shard_block_bytes']} reduce_bytes={st['reduce_bytes']} "
            f"live_tiles={st.get('live_tiles')}/{st.get('total_tiles')} "
            f"walk_steps={st.get('walk_steps')} regrows={st['regrows']} "
            f"shard_methods={st.get('shard_methods')} max_memory_allocated="
            f"{torch.cuda.max_memory_allocated()} launches={launches}")
        runs[f"mr_{label}"] = launches
        return launches

    got = call("lfvt", method="lfvt")
    if got["K1"] != live:
        raise AssertionError(f"MR lfvt launched K1 {got['K1']} times, "
                             f"{live} shards have live rows")
    t0 = time.perf_counter()
    repro_torch.join(R, Ss, MAIN_T, n_shards=MR_SHARDS, method="lfvt")
    log(f"[mr lfvt] warm_wall_s={time.perf_counter() - t0:.3f}")
    log_profile("warm mr lfvt join", device_profile(
        lambda: repro_torch.join(R, Ss, MAIN_T, n_shards=MR_SHARDS,
                                 method="lfvt"),
        ("lfvt_walk_kernel",)), "K1")
    got = call("auto")
    if got["K1"] + got["K3"] < 1:
        raise AssertionError(f"MR auto launched no kernel: {got}")
    got = call("kernel_bitmap", method="kernel_bitmap")
    if not live <= got["K2"] <= MR_SHARDS:
        raise AssertionError(f"MR kernel_bitmap launched K2 {got['K2']} "
                             f"times for {live} live shards")
    log_profile("warm mr kernel_bitmap join", device_profile(
        lambda: repro_torch.join(R, Ss, MAIN_T, n_shards=MR_SHARDS,
                                 method="kernel_bitmap"),
        ("bitmap_join_kernel", "bitmap_union_kernel")), "K2")


def main() -> int:
    if sys.argv[1:2] == ["--mr-child"]:
        return mr_child(*sys.argv[2:4])
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this script needs "
              "one GPU", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch.data.synth import make_join_dataset
    from repro_torch.kernels import _build, bitmap_join

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
    build_logs: dict = {}
    took = _build.build(extra_flags=("-Xptxas", "-v"), logs=build_logs)
    log(f"[build] {json.dumps(took)} total_s={time.perf_counter() - t0:.3f}")
    k7_regs = ptxas_registers(build_logs.get("flash_attention", ""),
                              K7_KERNEL_NAMES)
    for line in k7_regs:
        log(f"[build K7] {line}")
    onehot_regs = ptxas_registers(build_logs.get("onehot_join", ""),
                                  ("onehot_join_kernel",))
    for line in onehot_regs + onehot_smem_lines():
        log(f"[build K4/K5] {line}")
    walk_regs = ptxas_registers(build_logs.get("lfvt_walk", ""),
                                ("lfvt_walk_kernel",
                                 "lfvt_walk_planned_kernel"))
    for line in walk_regs + walk_smem_lines():
        log(f"[build K1/K6] {line}")
    bitmap_regs = ptxas_registers(build_logs.get("bitmap_join", ""),
                                  ("bitmap_join_kernel",
                                   "bitmap_union_kernel"))
    for line in bitmap_regs + bitmap_smem_lines():
        log(f"[build K2/K3] {line}")

    # worker processes make the livej data and run the measures phase's
    # CPU side while this process drives the card; it keeps to one CPU
    # thread meanwhile, or its CPU ops wait on OpenMP threads that the
    # workers have descheduled. The pool is done before the timed phases.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    pool = multiprocessing.get_context("spawn").Pool(
        POOL_WORKERS, initializer=init_worker)
    try:
        t0 = time.perf_counter()
        livej_async = pool.apply_async(make_join_dataset,
                                       ("livej", MAIN_SCALE, 0))
        configs = sorted(measures_configs(),
                         key=lambda c: CPU_ORDER.index(c[1]))
        cpu_async = pool.map_async(cpu_join, configs, chunksize=1)
        mr_cfgs = mr_configs()
        mr_async = pool.map_async(cpu_mr_join, mr_cfgs, chunksize=1)

        # ---- phase 2: the measures phase ----------------------------- #
        cuda_out, fronts, sizes = measures_cuda(configs)
        mr_out = mr_measures_cuda(mr_cfgs)
        kill_and_resume(mr_out[0][0])
        measures_compare(configs, cuda_out, fronts, sizes, cpu_async)
        mr_measures_compare(mr_cfgs, mr_out, mr_async)
        R, S = livej_async.get()
        gen_s = time.perf_counter() - t0
    finally:
        pool.terminate()
        pool.join()
    torch.set_num_threads(threads)
    runs: dict = {}   # main-path run -> launches per kernel id

    # ---- data ----------------------------------------------------------- #
    t0 = time.perf_counter()
    Ss = S.sort_by_size()
    flat = Ss.flat_lfvt()
    enc_s = time.perf_counter() - t0
    log(f"[data] livej |R|={len(R)} |S|={len(S)} "
        f"elements={R.total_elements()}+{S.total_elements()} "
        f"ready_after_s={gen_s:.3f} (made in a worker) "
        f"encode_s={enc_s:.3f} "
        f"seq_tuples={len(flat.seq_row)} max_seq_len={flat.max_seq_len}")

    # ---- phase 3: the lfvt join at full size ------------------------- #
    torch.cuda.reset_peak_memory_stats()
    st: dict = {}
    t0 = time.perf_counter()
    res, runs["lfvt"] = counted(lambda: repro_torch.join(
        R, Ss, MAIN_T, method="lfvt", stats=st))
    join_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    again = repro_torch.join(R, Ss, MAIN_T, method="lfvt")
    warm_s = time.perf_counter() - t0
    if again.pairs != res.pairs:
        raise AssertionError("a repeated join gave other pairs")
    log_profile("warm lfvt join", device_profile(
        lambda: repro_torch.join(R, Ss, MAIN_T, method="lfvt"),
        ("lfvt_walk_kernel",)), "K1")
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
        f"max_memory_allocated={peak} launches={runs['lfvt']} "
        f"oracle_rows={len(rows)} oracle_pairs={len(want_pairs)}")

    # ---- phase 4: the front door's default call, and the other
    # families, at the same size ----------------------------------------- #
    def front_door(label, **kw):
        stx: dict = {}
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out, runs[label] = counted(lambda: repro_torch.join(
            R, Ss, MAIN_T, stats=stx, **kw))
        wall = time.perf_counter() - t0
        if out.pairs != res.pairs:
            raise AssertionError(
                f"{label} join: {len(out.pairs)} pairs, the lfvt join "
                f"{len(res.pairs)}")
        log(f"[join {label}] plan.method={out.plan.method} "
            f"decided={out.plan.decided} pairs={len(out.pairs)} "
            f"(== lfvt) wall_s={wall:.3f} r_blocks={stx['r_blocks']} "
            f"live_tiles={stx.get('live_tiles')}/"
            f"{stx.get('total_tiles')} regrows={stx['regrows']} "
            f"output_bytes={stx['output_bytes']} max_memory_allocated="
            f"{torch.cuda.max_memory_allocated()} "
            f"launches={runs[label]}")
        return out

    auto = front_door("auto")
    log(f"[auto] scores={json.dumps(auto.plan.scores)}")
    if auto.plan.method != "popcount":
        log(f"[auto] picked {auto.plan.method!r}, not 'popcount'; "
            "running method='popcount' as well")
        front_door("popcount", method="popcount")
        MAIN_RUN["K3"] = "popcount"
    t0 = time.perf_counter()
    repro_torch.join(R, Ss, MAIN_T)
    log(f"[auto] warm_wall_s={time.perf_counter() - t0:.3f}")
    # K3's share: its union pass and its join kernel
    log_profile("warm auto join", device_profile(
        lambda: repro_torch.join(R, Ss, MAIN_T),
        ("bitmap_join_kernel", "bitmap_union_kernel")), "K3")
    for method in ("kernel_bitmap", "kernel_onehot", "onehot"):
        front_door(method, method=method)
    # the other families warm, against the default call's pairs
    for method in ("kernel_bitmap", "kernel_onehot", "onehot"):
        t0 = time.perf_counter()
        warm = repro_torch.join(R, Ss, MAIN_T, method=method)
        wall = time.perf_counter() - t0
        if warm.pairs != auto.pairs:
            raise AssertionError(f"warm {method} join: {len(warm.pairs)} "
                                 f"pairs, auto {len(auto.pairs)}")
        log(f"[join {method}] warm_wall_s={wall:.3f} pairs="
            f"{len(warm.pairs)} (== auto)")
    log_profile("warm kernel_bitmap join", device_profile(
        lambda: repro_torch.join(R, Ss, MAIN_T, method="kernel_bitmap"),
        ("bitmap_join_kernel", "bitmap_union_kernel")), "K2")
    log_profile("warm kernel_onehot join", device_profile(
        lambda: repro_torch.join(R, Ss, MAIN_T, method="kernel_onehot"),
        ("onehot_join_kernel",)), "K4")

    # ---- phase 4b: the MapReduce driver at full size ----------------- #
    t0 = time.perf_counter()
    mr_phase(R, Ss, res.pairs, runs)
    log(f"[mr] phase_s={time.perf_counter() - t0:.3f}")

    # ---- phase 5: the dedup service on the livej corpus -------------- #
    t0 = time.perf_counter()
    k6 = serve_phase(R, Ss, runs, dev)
    k6["registers"] = walk_regs
    log(f"[serve] phase_s={time.perf_counter() - t0:.3f}")

    # ---- phase 6: LLM serving (qwen2-1.5b, K7) ------------------------ #
    t0 = time.perf_counter()
    llm_phase(runs, dev)
    log(f"[llm] phase_s={time.perf_counter() - t0:.3f}")
    for kid, label in MAIN_RUN.items():
        if runs[label][kid] <= 0:
            raise AssertionError(f"the {label} run never launched {kid}")

    # ---- phase 7: kernels against their plain versions -------------- #
    # the driver's block (rows cut in input order) with the most rows
    # that the join paired, so the main threshold's mask is not empty
    block = int(np.bincount(paired // BLOCK_ROWS).argmax()
                if len(paired) else 0)
    checks = {t: kernel_check(Ss, flat, R, block, t, dev)
              for t in (MAIN_T, WIDE_T)}
    got, operands, lanes, _, ms, plain_ms, _, _ = checks[MAIN_T]
    err = max(c[3] for c in checks.values())
    bound_ms, bound_by, moved, ops_n = walk_bound(
        operands, got, operands[0], operands[7], operands[8], lanes)
    lane_steps, win_steps = int(lanes[:, 0].sum()), int(lanes[:, 1].sum())
    # the walk's dependent-gather traffic (8 B of seq_row/seq_next per
    # lane step, a 4 B count update per in-window step): what K1 moves
    # through the caches, beside the bytes the function must move
    step_bytes = 8 * lane_steps + 4 * win_steps
    for t, c in checks.items():
        log(f"[kernel K1] t={t} block={block} K1 vs plain bit-equal: "
            f"live_tiles={len(c[1][0])} Lr={c[1][1].shape[1]} "
            f"NP={c[1][5].shape[1]} pairs={int(c[0][1].sum())} "
            f"walk_steps={int(c[0][2].sum())} "
            f"early_stops={int(c[0][3].sum())} "
            f"lane_steps={int(c[2][:, 0].sum())} "
            f"runs_per_lane_mean={c[7].mean():.3f} "
            f"runs_per_lane_max={int(c[7].max())} "
            f"window_steps={int(c[2][:, 1].sum())} ctas={c[6][0]} "
            f"widest_window={c[6][4]} smem_cols={c[6][1]} "
            f"dynamic_smem_bytes={c[6][2]} column_passes_max={c[6][3]} "
            f"ms={c[4]:.4f} plain_ms={c[5]:.4f}")
    log(f"[bound K1] t={MAIN_T} bound_ms={bound_ms:.6f} "
        f"bound_by={bound_by} bytes={moved} int32_ops={ops_n} "
        f"k1_over_bound={ms / bound_ms:.1f} step_traffic_bytes="
        f"{step_bytes} step_traffic_gb_per_s="
        f"{step_bytes / ms / 1e6:.1f}")
    kernels = {"K1": dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=None, registers=walk_regs,
        library_note="no single PyTorch call computes the walk with "
                     "its counters",
        check=f"bit-equal to its plain version on the card at "
              f"t={MAIN_T} and t={WIDE_T}"), "K6": k6}

    rows_blk = slice(block * BLOCK_ROWS, (block + 1) * BLOCK_ROWS)
    W = max((max(R.universe, Ss.universe) + 31) // 32, 1)
    s_bm = torch.tensor(Ss.bitmaps(W).view(np.int32), device=dev)
    tiled_err = dict.fromkeys(("K2", "K3", "K4", "K5"), 0)
    lib = None
    for family, kids in (("bitmap", ("K2", "K3")),
                         ("onehot", ("K4", "K5"))):
        for t in (MAIN_T, WIDE_T):
            args = tiled_operands(R, Ss, rows_blk, t, family, None, dev,
                                  s_bm)
            if lib is None:   # K2-K5's yardstick: the same block's product
                lib = membership_matmul_ms(args[0][0], args[0][2])
                log(f"[library K2-K5] bf16 torch.matmul of the block's "
                    f"unpacked membership matrices (product only) "
                    f"ms={lib:.4f}")
            onehot_main = family == "onehot" and t == MAIN_T
            if onehot_main:
                live_cells, products, stage_tiles = onehot_work(args)
            wrap_kw, sparse = {}, None
            if family == "bitmap":
                # the compressed S, as the driver builds it once per join
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sp = bitmap_join.compress_s(args[0][2])
                torch.cuda.synchronize()
                sp_s = time.perf_counter() - t0
                wrap_kw = {"s_sparse": sp}
                if t == MAIN_T:
                    sparse = (sp, common_words(args))
                log(f"[work K2/K3] t={t} block={block} compress_s_s="
                    f"{sp_s:.4f} s_pairs={int(sp.counts.sum())} s_slots="
                    f"{sp.pairs.shape[0]} s_bytes="
                    f"{sum(x.numel() * x.element_size() for x in sp[:3])} "
                    + json.dumps(bitmap_work(args, sp)))
            for kid in kids:
                kgot, kerr, kms, kplain, kpairs, kq = tiled_check(
                    kid, args, t, t == MAIN_T, **wrap_kw)
                tiled_err[kid] = max(tiled_err[kid], kerr)
                if t == WIDE_T and kpairs <= 0:
                    raise AssertionError(f"{kid} found no pair in block "
                                         f"{block} at t={t}")
                line = (f"[kernel {kid}] t={t} block={block} "
                        f"tiles={args[3]} live_tiles={len(args[2][0])} "
                        f"in_window_cells={args[4]} pairs={kpairs} "
                        "bit-equal to plain")
                if t == MAIN_T:
                    b_ms, b_by, b_bytes, b_ops = tiled_bound(kid, args,
                                                             kgot, sparse)
                    kernels[kid] = dict(
                        ms=kms, plain_ms=kplain, bound_ms=b_ms,
                        bound_by=b_by, library_ms=lib, library_note=(
                            "one bf16 torch.matmul of the block's "
                            "pre-unpacked membership matrices: the same "
                            "cells' intersection sizes (the product only, "
                            "no predicate, window or mask)"))
                    line += (f" ms={kms:.4f} plain_ms={kplain:.4f} "
                             f"bound_ms={b_ms:.6f} bound_by={b_by} "
                             f"bytes={b_bytes} ops={b_ops} "
                             f"over_bound={kms / b_ms:.1f}")
                    if family == "bitmap":
                        d_ms, d_by, d_bytes, d_ops = tiled_bound(
                            kid, args, kgot)
                        kernels[kid].update(queued_ms=kq)
                        line += (f" queued_ms={kq:.4f} queued_over_bound="
                                 f"{kq / b_ms:.1f} dense_bound_ms={d_ms:.6f} "
                                 f"dense_bound_by={d_by} dense_bytes="
                                 f"{d_bytes} dense_ops={d_ops} library_ms="
                                 f"{lib:.4f} over_library={kms / lib:.4f}")
                if onehot_main:
                    TM, TN, _ = args[3]
                    issued = 2 * TM * TN * 128 * products / (kms * 1e9)
                    dense = (2 * live_cells * 32 * args[0][0].shape[1]
                             / (kms * 1e9))
                    line += (f" live_cells={live_cells} stage_products="
                             f"{products} of {stage_tiles} live stage-tiles"
                             f" ({products / stage_tiles:.3f})"
                             f" issued_tops={issued:.1f} issued_share="
                             f"{issued * 1e12 / INT8_OPS_PER_S:.3f}"
                             f" live_dense_tops={dense:.1f} library_ms="
                             f"{lib:.4f} over_library={kms / lib:.3f}")
                log(line)
            if family == "bitmap" and t == MAIN_T:
                pad_sheet_check(R, Ss, rows_blk, s_bm, sp, dev)
    for kid in ("K2", "K3"):
        kernels[kid]["registers"] = bitmap_regs
    for kid in ("K4", "K5"):
        kernels[kid]["registers"] = onehot_regs
    dense, dense_work = dense_case(dev)
    log(f"[work K2/K3 dense] kosarak t={WIDE_T} " + json.dumps(dense_work))
    for kid, (kms, kq, kplain, bound, d_bound, kpairs) in dense.items():
        log(f"[kernel {kid} dense] kosarak first {BLOCK_ROWS} rows "
            f"t={WIDE_T} pairs={kpairs} bit-equal to plain ms={kms:.4f} "
            f"queued_ms={kq:.4f} "
            f"plain_ms={kplain:.4f} bound_ms={bound[0]:.6f} "
            f"bound_by={bound[1]} bytes={bound[2]} ops={bound[3]} "
            f"dense_bound_ms={d_bound[0]:.6f} dense_ops={d_bound[3]}")
    for kid in ("K2", "K3", "K4", "K5"):
        kernels[kid].update(
            max_abs_err=tiled_err[kid],
            check=f"bit-equal to its plain version on the card at "
                  f"t={MAIN_T} and t={WIDE_T}, and at m=20, n=300, "
                  f"W=3 with tiles (32, 128, 2)" + (
                      f", and on the kosarak block at t={WIDE_T} (dense "
                      "words)" if kid in ("K2", "K3") else ""))
    del s_bm
    log(f"[kernel small] m=20 n=300 W=3 tiles=(32, 128, 2) "
        f"bit-equal to plain, pairs={small_tile_case(dev)}")
    k7 = [k7_check(*case, dev) for case in K7_CASES]
    for case, c in zip(K7_CASES, k7):
        b, l, h, kv, d, window, dtype = case[1:]
        lib = c["library_ms"]
        log(f"[kernel K7] {c['label']}: B={b} L={l} H={h} "
            f"KV={'merged' if kv is None else kv} D={d} window={window} "
            f"{str(dtype)[6:]} max_abs_err={c['max_abs_err']:.3e} (atol = "
            f"rtol = {c['tol']}) plain_ms={c['plain_ms']:.3f} "
            f"ms={c['ms']:.4f} bound_ms={c['bound_ms']:.6f} "
            f"bound_by={c['bound_by']} bytes={c['bytes']} "
            f"flops={c['flops']} share_of_bound="
            f"{c['bound_ms'] / c['ms']:.3f} tflops="
            f"{c['flops'] / c['ms'] / 1e9:.1f} sdpa_ms={lib} over_sdpa="
            f"{c['ms'] / lib if lib else None}")
    kernels["K7"] = dict(
        max_abs_err=max(c["max_abs_err"] for c in k7), ms=k7[0]["ms"],
        plain_ms=k7[0]["plain_ms"], bound_ms=k7[0]["bound_ms"],
        bound_by=k7[0]["bound_by"], library_ms=k7[0]["library_ms"],
        library_note="one torch.nn.functional.scaled_dot_product_attention("
                     "is_causal=True, enable_gqa=True) on the same q, k, v "
                     "as (B, heads, L, D) views",
        registers=k7_regs,
        check="within the reference's tolerances of its plain version (bf16 "
              "atol = rtol = 2e-2, float32 2e-5) at " + ", ".join(
                  c["label"] for c in k7))

    out = []
    for kid, (_, name, _, source, replaces) in KERNELS.items():
        out.append({"name": name, "id": kid, "status": "ported",
                    "route": "cuda", "source": source, "replaces": replaces,
                    "launches": runs[MAIN_RUN[kid]][kid],
                    "main_run": MAIN_RUN[kid], **kernels[kid]})
    not_ported = [{"id": k, "name": n, "status": "not_ported", "replaces": r}
                  for k, n, r in NOT_PORTED]
    log(f"[total] s={time.perf_counter() - T_START:.3f} of the 1200 s "
        "limit")
    print(json.dumps({"kernels": out, "not_ported": not_ported}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
