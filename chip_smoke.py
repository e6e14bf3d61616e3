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
  2. measures phase: at |R| = |S| = 4 000 (``dblp``) and 3 000
     (``kosarak``; ``MEASURES_SCALE``), all 4 measures x
     t in {0.5, 0.7, 0.9, 2/3} x both emit modes, for ``lfvt``
     (``dblp``-shaped) and for ``popcount``, ``onehot``,
     ``kernel_bitmap`` and ``kernel_onehot`` (``kosarak``-shaped; the
     last two take ``emit="mask"``, where they run K3 and K5 as
     ``popcount`` and ``onehot`` do, at t = 0.9 only),
     through the port's driver on the card and, meanwhile, in CPU worker
     processes (one of which makes the livej data first); the two must
     give identical pairs (compared as sorted int64 keys) and counters.
     For each measure and emit mode one of the four bitmap methods also
     runs through ``repro_torch.join`` on the card at t = 0.9, and its
     pairs (and mask) must equal the CPU driver's. Then the MapReduce
     driver (``repro_torch.mr_cf_rs_join``, 4 load-aware shards) on the
     same data, on the card and in the workers (``mr_configs``): every
     method and ``auto``, each measure at its ``MR_T`` (dice at exactly
     2/3; the bitmap methods at jaccard and dice), both emits; ``hash``
     with ``lfvt``; one managed run per
     measure under a seeded ``MR_FAULT_PLANS`` plan, whose pairs and
     resilience counters must equal the CPU's and whose only
     degradations may be the injected ones. The
     multi-device path (``mesh=make_host_mesh(4)``, 4 slots on the card)
     runs ``lfvt`` on dblp under both schedules and both emits and the
     stacked ``popcount`` and ``kernel_onehot`` reduces on kosarak with
     ``emit="mask"`` (``MESH_MEASURE_CALLS``): each must equal the card's
     loop-path MR call in pairs and in the stats the two share, and
     launch K6, K1, K3 or K5. Each host baseline (``core/baselines.py``)
     runs once in a worker on a 1 000 x 1 000 kosarak slice at Jaccard
     t = 0.8, and its pairs must equal the card's ``lfvt`` join of the
     slice. The one-call wrappers of ``kernels/ops.py`` (``OPS_CALLS``:
     ``join_pairs`` for ``bitmap`` (K2), ``onehot`` (K4), ``lfvt`` (K1)
     and ``lfvt_ref``, and ``lfvt_walk_join_mask`` (K1)) run once each
     on the card and in a worker at Jaccard t = 0.5: equal pairs and
     stats. While the workers finish, the card runs the training
     phase's untimed half (see 6b). The pool is done before any timed
     phase starts;
  3. join phase: ``repro_torch.join(R, S, 0.8, method="lfvt")`` on the
     card with the ``livej``-shaped dataset (|R| = |S| = 100 000), the K1
     launch count read around it, and its pairs for 64 sampled R rows
     (half at random, half among rows with pairs) held against exact
     overlaps computed here with numpy; then the join repeated, once on
     the host clock and once under ``torch.profiler`` (device-busy time,
     K1's share, the idle share);
  4. front-door phase: the planner's calibration scales (from the
     committed ``BENCH_pr*.json`` rows) printed; ``repro_torch.join(R,
     S, 0.8)`` with no method
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
     n_shards=8)`` with ``lfvt`` (cold, then warm under the profiler: K1
     must launch
     once for each shard with a live row), ``auto`` (its per-shard picks
     printed) and ``kernel_bitmap`` (K2 per shard, profiled), each equal
     to the lfvt join's pairs, with the partition's ``psi``, intervals,
     shard loads, R replication and shuffle bytes, and the host's
     partition, routing and per-shard LFVT encode timed apart; then the
     multi-device path, ``repro_torch.join(R, S, 0.8,
     mesh=make_host_mesh(8))`` (8 slots on the one card): ``lfvt`` under
     ``schedule="planned"`` (K6 once per shard with rows on both sides;
     counted, then profiled: device-busy, K6's share, the idle share) and
     ``"static"`` (K1 as often), with ``n_buckets``, pad waste and live
     tiles, and the stacked ``popcount`` reduce with ``emit="pairs"``
     (K3 per shard; the host's globally padded shard packing timed
     apart), each equal to the lfvt join's pairs; then the managed paths
     (``managed_phase``, ``checkpoint_dir=`` under ``build/managed``,
     the guardrail's budget resolved from the card): the single-device
     ``lfvt`` call, the 8-shard loop call and the 8-slot mesh call under
     ``"planned"``, each with no split and no degradation, the lfvt
     join's pairs and the unmanaged calls' launches and walk counters;
     the loop call again with the budget pinned to cut every shard into
     2-4 spans (each shard's S encoded once); meanwhile the loop call
     runs in a child process on the livej sets saved under
     ``build/managed``, is killed (SIGKILL) at its 2nd checkpoint write,
     and a second child resumes it: the same pairs, a task resumed;
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
     then K6 (and K1 on its live tiles) on a 256-row probe (a stream-C
     micro-batch) against the grown corpus, bit-equal to its plain
     version, with the count of the
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
     time, K7's share, the idle share, device events per step); then
     training (phase 6b): qwen2-1.5b at full width and depth, bf16 params
     with float32 master weights and moments (attention conditioned),
     ``attn_impl="jnp"``, ``remat="dots"``, through ``repro_torch.
     Trainer`` and ``make_train_step`` with ``AdamWConfig(lr=3e-4,
     warmup_steps=1)``: 6 steps of 8 x 4 096 tokens as 4 microbatches on
     one repeated ``TokenStream`` batch (each step's loss and grad norm;
     the warm step's wall, tokens/s, the model-FLOPs rate and peak
     memory; the first loss within 2 of ln V, the last below it, K7 never
     launched), one step under ``torch.profiler``. Its untimed half runs
     in phase 2, during the CPU workers' tail: at 4 layers, full width,
     remat ``"dots"`` against ``"none"`` (equal loss, gradients within
     ``REMAT_GRAD_TOL``) and 4 microbatches against 1 (loss and grad
     norm within ``MICRO_LOSS_TOL``, ``MICRO_NORM_TOL``); one layer at
     full width in float32, the card's loss and every gradient leaf
     against the CPU's within ``F32_GRAD_TOL``; a flash build refusing
     autograd on the card; and, meanwhile, ``python3 chip_smoke.py
     --train-child kill|full|resume DIR`` (``repro_torch.launch.train``
     at qwen2's smoke config, deterministic algorithms, 12 steps,
     checkpoints every 4): the killed child dies once its step-8
     checkpoint is out, the resumed one must print ``resumed from
     checkpoint at step 8`` and end on the uninterrupted child's final
     checkpoint bit for bit; then the other families (``FAMILY_RUNS``), each at full width from seeded
     bf16 weights made on the card (attention conditioned), freed before
     the next: qwen2-moe-a2.7b (24 layers, 8 x 2 048 tokens),
     recurrentgemma-2b (26 layers, 4 x 4 096 tokens: K7 at D = 256 with
     its 2 048 window, the ring cache wrapping), xlstm-350m (24 layers,
     4 x 512), musicgen-large (48 layers, 4 x 1 024, D = 64), llava-
     next-34b (16 of 60 layers, the 576-patch stub through
     ``prefill(extra_embeds=)`` and 8 decode steps) and phi3.5-moe (8
     of 32 layers, 8 x 256 tokens, 8 decode steps); each prefill must
     launch K7 once per attention layer, and its last-token logits must
     agree with an ``attn_impl="jnp"`` build's within ``LLM_LOGIT_TOL``
     (the MoE builds under the flash build's routing, ``RouteLog``,
     with the share of (token, layer) top-k sets they route alike on
     their own logged); then sharded execution over the port's mesh
     (phase 6d, ``parallel_phase``, every slot on the one card):
     qwen2-1.5b at full width and depth served at tp = 2 on (data,
     model) = (1, 2) slots behind ``ServeEngine`` (8 x 2 048 tokens, 16
     greedy tokens; K7 once per slot per layer, 56 a prefill, each slot
     6 query heads on 1 KV head), its last-token logits against the
     same weights unsharded at tp = 2 on one slot within
     ``LLM_LOGIT_TOL`` and its greedy tokens equal while the unsharded
     run's top-2 gap exceeds it, with the collectives' bytes and calls
     per kind a prefill and a decode step; the same model built at
     tp = 16 on one slot (16 padded heads on 2 KV heads: K7 at group 8),
     its flash prefill against its plain prefill; qwen2-moe-a2.7b at
     full width cut to 4 of 24 layers, its 60 experts over (1, 4) slots,
     the prefill against the unsharded build under one routing; and
     qwen2-1.5b trained 3 steps on (2, 2) slots with ZeRO-1 (remat
     "dots", plain attention, one batch of 8 x 4 096 tokens, each data
     slot 4 rows as 2 microbatches) against the single-slot step at 4
     microbatches on the same batch and weights: each step's loss and
     grad norm within ``PAR_LOSS_TOL`` and ``PAR_GNORM_TOL``, the master
     weights' median difference within ``PAR_MEDIAN_TOL`` x lr and their
     largest within ``PAR_FLIPS`` x the steps' lrs; step time, tokens/s,
     peak memory, collective bytes a step; then the last modules (phase
     6e, ``state_moe_phase``, every slot on the one card):
     recurrentgemma-2b (26 layers, 4 x 4 096 tokens) and xlstm-350m (24
     layers, 4 x 512) at full width served at tp = 2 on (data, model) =
     (1, 2) slots, their recurrent (``state``) weights split over the
     two, against the same weights on one slot (last-token logits within
     ``LLM_LOGIT_TOL``, greedy tokens equal while the one slot's top-2
     gap exceeds it; K7 once per slot per attention layer, 16 a
     recurrentgemma prefill); qwen2-moe-a2.7b at full width, 4 of 24
     layers, on (2, 2) slots, its data groups in lockstep under one
     routing of the whole 8 x 2 048 batch, its prefill against the
     unsharded build under one routing (``RouteLog``); its ZeRO-1 train
     step at 2 of 24 layers on (2, 2) slots, 2 steps on 4 x 2 048 tokens
     as 2 microbatches of the whole batch, against the single-slot step
     by the ``PAR_*`` bounds; and one cell of the dry run
     (``launch/dryrun.py``, ``DRY_RUN_CELL``) on 16 x 16 ``meta`` slots,
     its roofline terms beside the card's name and power limit;
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
     4 096; merged, and with its 2 KV heads in place), two float32
     cases, the recurrentgemma-2b prefill (B = 4, L = 4 096, 10 heads on
     1 KV head of D = 256, window 2 048) and a float32 D = 256 case, each
     timed beside its bound and beside one
     ``scaled_dot_product_attention`` (``is_causal=True``, or the
     window's band as a boolean mask; ``enable_gqa=True`` for the
     in-place cases); the bf16 kernel's registers and spills as ``nvcc
     -Xptxas -v`` reports them;
  8. one ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}`` line.

Exits 2 without a result when torch sees no CUDA device. ``python3
chip_smoke.py --mr-child kill|resume DIR SETS`` and ``--train-child
kill|full|resume DIR`` are the kill-and-resume checks' children, not
smoke runs.
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
import signal
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
# the measures phase: (dataset, methods)
MEASURE_SETS = (("dblp", ("lfvt",)), ("kosarak", BITMAP_METHODS))
# |R| = |S| = 5 000 x scale: dblp 4 000; kosarak 3 000 (it was 4 000): the
# CPU workers' bitmap joins grow with |R| |S| and were the measures
# phase's long pole (984 of 1 204 worker-seconds at 4 000)
MEASURES_SCALE = {"dblp": 0.8, "kosarak": 0.6}
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
# boundary with dice. The bitmap methods take jaccard and dice, one emit
# a measure, in turn (their plain versions cost the CPU workers 10-50 s
# a call), and the whole-block walk (lfvt_ref, 43 s a call there) two
# measures.
MR_T = {"jaccard": 0.5, "cosine": 0.7, "dice": 2 / 3, "overlap": 0.9}
MR_SETS = (("dblp", ("lfvt", "auto"), 2, MEASURES),
           ("dblp", ("lfvt_ref",), 1, MEASURES[:2]),
           ("kosarak", BITMAP_METHODS + ("auto",), 1, MEASURES[::2]))
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
# the kill-and-resume child: the livej MR loop call (lfvt, MR_SHARDS
# shards) on the sets the parent saved, killed at its 2nd checkpoint write
MR_KILL_PLAN = "checkpoint_write:kill:2"
# the managed phase (after the mesh phase): its checkpoints and the saved
# livej sets under build/MANAGED_DIR; the forced-split loop call pins a
# budget that cuts every shard into MANAGED_SPLIT_SPANS (least, most) spans
MANAGED_DIR = "managed"
MANAGED_SPLIT_SPANS = (2, 4)
# the multi-device path (mesh=) in the measures phase, on
# MR_MEASURE_SHARDS slots of the one card: (dataset, method, measure,
# schedule, emit), each against the card's loop-path MR call of the same
# dataset, method, measure and emit; the stacked-bitmap reduce with
# emit="mask" (a measure whose loop call has that emit)
MESH_MEASURE_CALLS = (
    [("dblp", "lfvt", "jaccard", sched, emit)
     for sched in ("planned", "static") for emit in ("pairs", "mask")]
    + [("kosarak", method, "dice", None, "mask")
       for method in ("popcount", "kernel_onehot")])
# the stats a mesh call shares with the loop path's, by its kind (not
# regrows: the mesh compaction starts at one capacity grain, the loop
# path's at each shard's exact count)
MESH_SHARED = {"planned": ("result_pairs", "live_tiles", "walk_steps",
                           "early_stops"),
               "static": ("result_pairs",),
               None: ("result_pairs",)}
# the host baselines (core/baselines.py), one CPU worker task each, on a
# BASELINE_ROWS x BASELINE_ROWS slice of the kosarak measures data at
# Jaccard t = BASELINE_T (the dblp slice has no pair there); mr_rp_ppjoin
# and fs_join at MR_MEASURE_SHARDS shards
BASELINES = ("allpairs_join", "ppjoin_join", "mr_rp_ppjoin", "fs_join",
             "fasttelp_sj")
BASELINE_SET = "kosarak"
BASELINE_ROWS = 1000
BASELINE_T = 0.8
# one livej mesh shard's body against its plain version (on the CPU):
# row tiles around the first pair's R row, and size-0 S columns past the
# shard's own, as a bucket with a larger sibling pads them
MESH_SLICE_TILES = 16
MESH_SLICE_PAD_COLS = 5
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
# item 13's one-call wrappers of kernels/ops.py at the measures size
# (MEASURES_SCALE), Jaccard t = OPS_T, on the card and in a CPU
# worker: (label, dataset); "walk_mask" is lfvt_walk_join_mask, the
# others join_pairs(label, ...)
OPS_CALLS = (("bitmap", "kosarak"), ("onehot", "kosarak"),
             ("lfvt", "dblp"), ("lfvt_ref", "dblp"), ("walk_mask", "dblp"))
OPS_T = 0.5
OPS_STATS = ("pair_count", "live_tiles", "total_tiles", "dense_mask_bytes",
             "pair_bytes", "counts_bytes", "output_bytes", "regrows",
             "walk_steps", "early_stops", "walk_vmem_tile_bytes")
# the model-families phase: (arch, layers kept (None: all), prompts,
# prompt tokens, greedy tokens). Width is always full. llava-next-34b
# keeps 16 of its 60 layers (34.4 B parameters would be 68.9 GB in bf16,
# and init_params draws a leaf whole in float32: the MLP leaf alone would
# be 35 GB) and serves its 576-patch stub through prefill(extra_embeds=)
# and 8 decode steps; phi3.5-moe keeps 8 of 32 (41.9 B parameters, 83.8
# GB in bf16, do not fit in 80 GB)
FAMILY_RUNS = (
    ("qwen2-moe-a2.7b", None, 8, 2048, 16),
    ("recurrentgemma-2b", None, 4, 4096, 16),
    ("xlstm-350m", None, 4, 512, 16),
    ("musicgen-large", None, 4, 1024, 16),
    ("llava-next-34b", 16, 4, 64, 9),
    ("phi3.5-moe-42b-a6.6b", 8, 8, 256, 9),
)
# phase 6d, sharded execution over the port's mesh (its slots on the one
# card): qwen2-1.5b served on (data, model) = (1, 2) slots and built at
# tp = 16 on one slot (16 padded heads on 2 KV heads: K7 at group 8);
# qwen2-moe-a2.7b's experts over (1, 4) slots, cut to PAR_MOE_LAYERS of
# 24 layers; qwen2-1.5b trained on (2, 2) slots with ZeRO-1, each data
# slot's 4 rows as PAR_TRAIN_MICRO microbatches, against the single-slot
# step at 2 x PAR_TRAIN_MICRO microbatches on the same batch and weights
PAR_SERVE_NEW = 16
PAR_PADDED_TP = 16
PAR_MOE_ARCH = "qwen2-moe-a2.7b"
PAR_MOE_LAYERS = 4
PAR_MOE_BATCH = 4
PAR_TRAIN_STEPS = 3
PAR_TRAIN_MICRO = 2
# the sharded train step against the single-slot one (each reading is
# printed beside its tolerance; tools/sharded_train_faults.py prints them
# for two faults planted in the step, which they must fail):
#  * each step's loss within PAR_LOSS_TOL and grad norm within
#    PAR_GNORM_TOL, relative (the slots' bf16 partial sums round before
#    their all_reduce);
#  * the master weights' median difference within PAR_MEDIAN_TOL x the
#    last step's lr (test_torch_train_loop.py's median bound), checked
#    as the share of differences within it; the median and 99.9th
#    percentile of every PAR_SAMPLE_STRIDE-th difference are printed;
#  * the largest difference within PAR_FLIPS x the steps' lrs: the
#    weights are bf16 from the start, so an element whose gradient is
#    near 0 may take the other sign, and Adam then moves it the other way
#    by lr x |m^/(sqrt(v^) + eps)|, which b1 = 0.9 and b2 = 0.95 keep
#    within 1.0003 (Cauchy-Schwarz over the moments' weights), plus the
#    decay's 0.1 x |w| x lr. Whatever the gradient, Adam moves no element
#    further, so this bound alone cannot tell a wrong gradient: the
#    median and the grad norm do.
# Readings on an NVIDIA H100 80GB HBM3 at 700 W (the tool's run): the
# sound step, losses <= 7.6e-5, grad norms <= 2.0e-3, median 0.022 x lr
# (share within 0.05 x lr 0.71), largest 1.727e-3 of 1.845e-3; one data
# group's gradients dropped, grad norms 0.20-0.34 and losses to 3.0e-2
# off, median 0.65 x lr; no reduction over data, grad norms 0.43-6.5
# and losses to 9.9e-3 off, median 0.78 x lr; their largest differences,
# 1.800e-3 and 1.799e-3, pass the PAR_FLIPS bound.
PAR_LOSS_TOL = 1e-3
PAR_GNORM_TOL = 2e-2
PAR_MEDIAN_TOL = 0.05
PAR_SAMPLE_STRIDE = 211
PAR_FLIPS = 2.05
# phase 6e, the last modules over the port's mesh (its slots on the one
# card): the state-axis layers split over (data, model) = (1, 2) slots,
# each family at full width and depth as FAMILY_RUNS serves it (arch,
# prompts, prompt tokens); an MoE model routed whole over (2, 2) slots,
# qwen2-moe at full width cut to STATE_MOE_LAYERS of 24 layers (as 6d),
# its prefill of STATE_MOE_BATCH x 2 048 tokens, and its ZeRO-1 train
# step cut to STATE_MOE_TRAIN_LAYERS layers, STATE_MOE_TRAIN_STEPS steps
# on one batch of STATE_MOE_TRAIN_SEQS x 2 048 tokens as 2 microbatches
# (each the whole batch's rows 2k, 2k + 1, one a data slot), against the
# single-slot step at 2 microbatches, by the PAR_* bounds; and one cell
# of the dry run (launch/dryrun.py) on 16 x 16 meta slots
STATE_RUNS = (("recurrentgemma-2b", 4, 4096), ("xlstm-350m", 4, 512))
STATE_NEW = 16
# the state-axis families against one slot in float32 (each step's
# last-token logits, of the largest |logit|): the split path adds each
# layer's partial sums in another order than one product does, a few
# float32 roundings (2^-24) compounded through 24-26 layers; 1e-3 is 50x
# below LLM_LOGIT_TOL. In bf16 the partial sums round twice (each slot's
# product to bf16, then their sum), as the reference's own tensor-
# parallel products do under XLA, and these two archs amplify rounding
# more than qwen2 (the families phase's flash vs plain: 0.0341 against
# qwen2-moe's 0.0214): on an NVIDIA H100 80GB HBM3 at 700 W they read
# 0.065-0.067 of the largest logit in bf16 against 1.7e-5-2.1e-5 in
# float32, so bf16 is logged, not held
STATE_F32_TOL = 1e-3
STATE_MOE_LAYERS = 4
STATE_MOE_BATCH = 8
STATE_MOE_TRAIN_LAYERS = 2
STATE_MOE_TRAIN_SEQS = 4
STATE_MOE_TRAIN_STEPS = 2
DRY_RUN_CELL = ("qwen2-1.5b", "decode_32k")
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
    ("recurrentgemma-2b prefill, window 2048, MQA in place", 4, 4096, 10, 1,
     256, 2048, torch.bfloat16),
    ("D=256 ragged causal, float32", 1, 1000, 2, 1, 256, None,
     torch.float32),
)
#: the K7 case of RecurrentGemma's head dim 256, timed for its own row
K7_D256 = "recurrentgemma-2b prefill, window 2048, MQA in place"
#: K7's kernels as torch.profiler names them
K7_KERNEL_NAMES = ("flash_attention_wgmma", "flash_attention_f32")
# the reference's tolerances for K7 (tests/test_flash_attention.py):
# bf16 rounds p to bf16 before P.V, the plain version keeps float32;
# float32 differs from the full softmax in summation order and exp only
K7_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
# the training phase: qwen2-1.5b at full width and depth, bf16, remat
# "dots", attn_impl "jnp"; each step 8 sequences of train_4k's 4 096
# tokens (its global batch of 256 cut to 8) as 4 microbatches of 2
TRAIN_ARCH = "qwen2-1.5b"
TRAIN_SEQS = 8
TRAIN_LEN = 4096
TRAIN_MICRO = 4
TRAIN_STEPS = 6
TRAIN_LR = 3e-4
TRAIN_FIRST_LOSS_SLACK = 2.0   # the first loss within this of ln V
# the checks at a depth that fits both sides: remat "dots" against
# "none" and 4 microbatches against 1, CHECK_LAYERS at full width on
# CHECK_SEQS x CHECK_LEN tokens; then one layer at full width in float32,
# B = 1, L = F32_LEN, the card against the CPU
CHECK_LAYERS = 4
CHECK_SEQS = 4
CHECK_LEN = 1024
F32_LEN = 256
# tolerances, each a fraction: remat recomputes the same products, but
# the embedding's backward accumulates bf16 rows with atomics in any
# order (leaf max); the microbatched loss runs its GEMMs at another M and
# rounds each microbatch's bf16 gradients before the float32 sum (loss,
# relative; grad norm, relative); the float32 card-CPU gradients differ
# in summation order only (leaf max)
REMAT_GRAD_TOL = 1e-2
MICRO_LOSS_TOL = 5e-3
MICRO_NORM_TOL = 2e-2
F32_GRAD_TOL = 1e-4
# the kill-and-resume children: qwen2's smoke config through
# repro_torch.launch.train, checkpoints every TRAIN_CHILD_EVERY steps;
# the killed child dies once its step-TRAIN_KILL_AT checkpoint is out
TRAIN_CHILD_STEPS = 12
TRAIN_CHILD_EVERY = 4
TRAIN_KILL_AT = 8


T_START = time.perf_counter()


def log(*args) -> None:
    """Print one progress line, stamped with the seconds since start."""
    print(f"[{time.perf_counter() - T_START:7.1f}s]", *args, flush=True)


_WORKER_DATA: dict = {}


@functools.lru_cache(maxsize=None)
def measures_data(name: str):
    """The measures phase's dataset ``name`` at ``MEASURES_SCALE`` (made
    once a process)."""
    from repro_torch.data.synth import make_join_dataset
    return make_join_dataset(name, scale=MEASURES_SCALE[name], seed=0)


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


def save_sets(path, **colls) -> None:
    """Collections -> one ``.npz`` (per name: the elements end to end,
    their offsets, the ids, the universe and the size-sorted flag), so
    that a child process reads them instead of making them again."""
    arrays = {}
    for name, C in colls.items():
        arrays[f"{name}_elements"] = np.concatenate(C.sets)
        arrays[f"{name}_offsets"] = np.cumsum(C.sizes(), dtype=np.int64)
        arrays[f"{name}_ids"] = C.ids
        arrays[f"{name}_meta"] = np.array([C.universe, C.sorted_by_size])
    np.savez(path, **arrays)


def load_sets(path, *names) -> list:
    """``save_sets``' collections back, in the order of ``names``."""
    from repro_torch.core.sets import SetCollection
    out = []
    with np.load(path) as z:
        for name in names:
            universe, srt = (int(x) for x in z[f"{name}_meta"])
            out.append(SetCollection(
                np.split(z[f"{name}_elements"], z[f"{name}_offsets"][:-1]),
                universe, z[f"{name}_ids"], sorted_by_size=bool(srt)))
    return out


def mr_child(phase: str, ckpt: str, data: str) -> int:
    """The kill-and-resume check's child process, on the card: the livej
    MR loop call (``lfvt``, MR_SHARDS load-aware shards, t = MAIN_T) on
    the sets saved at ``data``, with ``checkpoint_dir=ckpt``; ``phase``
    'kill' arms MR_KILL_PLAN (the process dies at its 2nd checkpoint
    write), 'resume' prints the pair digest, the tasks it resumed, its
    guardrail splits and its wall as JSON."""
    import repro_torch
    R, Ss = load_sets(data, "r", "s")
    st: dict = {}
    t0 = time.perf_counter()
    out = repro_torch.join(
        R, Ss, MAIN_T, n_shards=MR_SHARDS, method="lfvt", stats=st,
        checkpoint_dir=ckpt,
        fault_plan=MR_KILL_PLAN if phase == "kill" else None)
    pr = np.array(sorted(out.pairs), np.int64).reshape(-1, 2)
    print(json.dumps({"digest": pair_digest(pr[:, 0], pr[:, 1]),
                      "tasks_resumed": st["tasks_resumed"],
                      "guardrail_splits": st["guardrail_splits"],
                      "wall_s": time.perf_counter() - t0}))
    return 0


def mr_child_proc(phase: str, ckpt, data) -> subprocess.Popen:
    """Start one ``mr_child`` in the background."""
    return subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--mr-child", phase,
         str(ckpt), str(data)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, REPRO_FAULT=""))


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
    intervals. 0.0 when the profiler saw no device events. The events are
    read from the profiler's raw results (nanoseconds), not through its
    per-op event tree, whose building takes minutes for a training
    step's ~70 000 device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, per = [], {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CUDA:
            continue
        start, end = ev.start_ns(), ev.end_ns()
        spans.append((start, end))
        per[ev.name()] = per.get(ev.name(), 0.0) + (end - start) / 1e9
    busy, reach = 0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            busy += end - max(start, reach)
            reach = end
    mine = sum(v for k, v in per.items() if any(key in k for key in keys))
    top = sorted(per.items(), key=lambda kv: -kv[1])[:5]
    return wall, busy / 1e9, mine, top, len(spans)


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
    3 600, W = 113), its first 1024 R rows
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


def train_child(mode: str, ckpt: str) -> int:
    """The kill-and-resume check's child process, on the card: qwen2's
    smoke config through ``repro_torch.launch.train.main`` with
    deterministic algorithms on (the parent sets CUBLAS_WORKSPACE_CONFIG
    before this interpreter imports torch). ``mode`` 'kill' dies by
    SIGKILL as soon as its step-TRAIN_KILL_AT checkpoint is published;
    'full' and 'resume' run to TRAIN_CHILD_STEPS."""
    if os.environ.get("CUBLAS_WORKSPACE_CONFIG") != ":4096:8":
        raise RuntimeError("the train child needs CUBLAS_WORKSPACE_CONFIG="
                           ":4096:8 set before torch is imported")
    torch.use_deterministic_algorithms(True)
    from repro_torch.launch import train
    from repro_torch.train import checkpoint
    if mode == "kill":
        write = checkpoint.CheckpointManager._write

        def write_then_die(self, step, arrays):
            write(self, step, arrays)
            if step == TRAIN_KILL_AT:
                os.kill(os.getpid(), signal.SIGKILL)
        checkpoint.CheckpointManager._write = write_then_die
    return train.main(["--arch", TRAIN_ARCH, "--smoke", "--steps",
                       str(TRAIN_CHILD_STEPS), "--ckpt-every",
                       str(TRAIN_CHILD_EVERY), "--ckpt-dir", ckpt])


def train_children() -> dict:
    """Start the kill-and-resume check: an uninterrupted child and one
    killed after its step-TRAIN_KILL_AT checkpoint, at once, in the
    background -> what ``train_resume`` needs."""
    import shutil
    base = ROOT / "build" / "train_kill"
    shutil.rmtree(base, ignore_errors=True)
    dirs = {m: base / m for m in ("full", "kill")}
    return dict(base=base, dirs=dirs, t0=time.perf_counter(),
                procs={m: train_child_proc(m, d) for m, d in dirs.items()})


def train_child_proc(mode, ckpt):
    return subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--train-child", mode,
         str(ckpt)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8"))


def child_output(proc) -> tuple:
    try:
        return proc.communicate(timeout=300)
    finally:
        proc.kill()


def train_resume(started: dict) -> str:
    """Finish the kill-and-resume check: a third child resumes the killed
    one, and the resumed run's final checkpoint must equal the
    uninterrupted one's bit for bit -> the log's summary."""
    import shutil
    procs, dirs = started["procs"], started["dirs"]
    outs = {m: child_output(p) for m, p in procs.items()}
    if procs["full"].returncode != 0:
        raise AssertionError(f"the uninterrupted train child failed: "
                             f"{outs['full'][1][-2000:]}")
    if procs["kill"].returncode != -signal.SIGKILL:
        raise AssertionError(f"the killed train child exited "
                             f"{procs['kill'].returncode}: "
                             f"{outs['kill'][1][-2000:]}")
    left = sorted(p.name for p in dirs["kill"].glob("step_*"))
    if f"step_{TRAIN_KILL_AT:08d}" not in left or (
            f"step_{TRAIN_CHILD_STEPS:08d}" in left):
        raise AssertionError(f"the killed child left {left}")
    resumed = train_child_proc("resume", dirs["kill"])
    out, err = child_output(resumed)
    if resumed.returncode != 0:
        raise AssertionError(f"the resumed train child failed: {err[-2000:]}")
    want = f"resumed from checkpoint at step {TRAIN_KILL_AT}"
    if want not in out.splitlines():
        raise AssertionError(f"the resumed child printed {out!r}")
    final = f"step_{TRAIN_CHILD_STEPS:08d}/arrays.npz"
    with np.load(dirs["full"] / final) as a, np.load(dirs["kill"] / final) \
            as b:
        if sorted(a.files) != sorted(b.files):
            raise AssertionError("the final checkpoints hold other keys")
        unequal = [k for k in a.files if a[k].dtype != b[k].dtype
                   or not np.array_equal(a[k], b[k])]
        n_keys = len(a.files)
    if unequal:
        raise AssertionError(f"resumed and uninterrupted checkpoints differ "
                             f"in {unequal}")
    shutil.rmtree(started["base"], ignore_errors=True)
    return (f"killed after step {TRAIN_KILL_AT} (left {left}), resumed to "
            f"{TRAIN_CHILD_STEPS}: final checkpoint == uninterrupted, "
            f"{n_keys} arrays bit for bit; uninterrupted child printed "
            f"{outs['full'][0].splitlines()[-1]!r}, resumed "
            f"{out.splitlines()[-1]!r} "
            f"s={time.perf_counter() - started['t0']:.3f}")


def leaf_err(got, want) -> float:
    """max |got - want| over max |want| of one gradient leaf."""
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp_min(
        1e-30))


def train_checks(cfg, dev) -> None:
    """Checks at depths that fit both sides: remat "dots" against "none"
    and 4 microbatches against 1 (CHECK_LAYERS at full width, bf16), one
    layer at full width in float32 on the card against the CPU, and the
    flash build's refusal of autograd on the card."""
    import dataclasses

    import repro_torch
    from repro_torch.errors import NoBackwardError
    from repro_torch.models.params import init_params, tree_leaves, tree_map
    from repro_torch.train.optimizer import global_norm
    from repro_torch.train.trainer import make_grad_fn
    cfg4 = dataclasses.replace(cfg, n_layers=CHECK_LAYERS)
    dots = repro_torch.build_model(cfg4)
    none = repro_torch.build_model(dataclasses.replace(cfg4, remat="none"))
    params = init_params(dots.param_specs(),
                         torch.Generator(device=dev).manual_seed(1),
                         device=dev)
    condition_attention(params, dots.dims, cfg.d_model)
    batch = repro_torch.TokenStream(cfg.vocab_size, CHECK_SEQS, CHECK_LEN,
                                    seed=1, device=dev).batch_at(0)
    peaks = {}
    res = {}
    for label, model, mb in (("dots", dots, 1), ("none", none, 1),
                             ("dots mb4", dots, 4)):
        torch.cuda.reset_peak_memory_stats()
        res[label] = make_grad_fn(model, mb)(params, batch)
        torch.cuda.synchronize()
        peaks[label] = torch.cuda.max_memory_allocated()
    (ld, _, gd), (ln, _, gn), (lm, _, gm) = (res[k] for k in
                                              ("dots", "none", "dots mb4"))
    remat_err = max(leaf_err(a, b) for a, b in zip(gd, gn))
    if float(ld) != float(ln) or remat_err > REMAT_GRAD_TOL:
        raise AssertionError(f"remat dots vs none: loss {float(ld)} vs "
                             f"{float(ln)}, grads {remat_err}")
    n1, n4 = (float(global_norm(dict(enumerate(g)))) for g in (gd, gm))
    loss_rel = abs(float(lm) - float(ld)) / abs(float(ld))
    norm_rel = abs(n4 - n1) / n1
    if loss_rel > MICRO_LOSS_TOL or norm_rel > MICRO_NORM_TOL:
        raise AssertionError(f"microbatches 4 vs 1: loss {float(lm)} vs "
                             f"{float(ld)}, grad norm {n4} vs {n1}")
    log(f"[train check] {CHECK_LAYERS} layers at full width, "
        f"{CHECK_SEQS}x{CHECK_LEN} tokens, bf16: remat dots vs none loss "
        f"{float(ld):.6f} == {float(ln):.6f}, grads max_err_over_leaf_max="
        f"{remat_err:.3e} (tolerance {REMAT_GRAD_TOL}); peak bytes "
        + json.dumps(peaks) + f"; microbatches 4 vs 1: loss {float(lm):.6f} "
        f"vs {float(ld):.6f} (rel {loss_rel:.2e}, tolerance "
        f"{MICRO_LOSS_TOL}), grad norm {n4:.6f} vs {n1:.6f} (rel "
        f"{norm_rel:.2e}, tolerance {MICRO_NORM_TOL})")
    del params, res, gd, gn, gm
    torch.cuda.empty_cache()

    # one layer at full width, float32: the card against the CPU
    cfg1 = dataclasses.replace(cfg, n_layers=1)
    model = repro_torch.build_model(cfg1)
    params = init_params(model.param_specs(),
                         torch.Generator(device=dev).manual_seed(2),
                         torch.float32, device=dev)
    condition_attention(params, model.dims, cfg.d_model)
    host = tree_map(lambda t: t.cpu(), params)
    stream = repro_torch.TokenStream(cfg.vocab_size, 1, F32_LEN, seed=2)
    t0 = time.perf_counter()
    lc, _, gc = make_grad_fn(model)(params, stream.batch_at(0))
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lh, _, gh = make_grad_fn(model)(host, dataclasses.replace(
        stream, device="cpu").batch_at(0))
    cpu_s = time.perf_counter() - t0
    errs = [leaf_err(a, b) for a, b in zip(gc, gh)]
    loss_err = abs(float(lc) - float(lh)) / abs(float(lh))
    if max(errs) > F32_GRAD_TOL or loss_err > F32_GRAD_TOL:
        raise AssertionError(f"float32 card vs CPU: loss {float(lc)} vs "
                             f"{float(lh)}, grads {errs}")
    log(f"[train check] 1 layer at full width, float32, 1x{F32_LEN} "
        f"tokens: card vs CPU loss {float(lc):.6f} vs {float(lh):.6f} (rel "
        f"{loss_err:.2e}), {len(errs)} gradient leaves, max_err_over_leaf_"
        f"max={max(errs):.3e} (tolerance {F32_GRAD_TOL}); card_s="
        f"{card_s:.3f} cpu_s={cpu_s:.3f}")
    del params, host, gc, gh
    torch.cuda.empty_cache()

    # the flash build refuses autograd on the card, and serves under
    # no_grad
    small = dataclasses.replace(repro_torch.get_config(TRAIN_ARCH,
                                                       smoke=True),
                                attn_impl="flash")
    model = repro_torch.build_model(small)
    params = init_params(model.param_specs(),
                         torch.Generator(device=dev).manual_seed(3),
                         device=dev)
    batch = repro_torch.TokenStream(small.vocab_size, 2, 64, seed=3,
                                    device=dev).batch_at(0)
    try:
        make_grad_fn(model)(params, batch)
    except NoBackwardError as e:
        refused = str(e)
    else:
        raise AssertionError("the flash build trained without a backward")
    with torch.no_grad():
        _, k7 = counted(lambda: model.forward(params, batch["tokens"]))
    if k7["K7"] != small.n_layers:
        raise AssertionError(f"the flash forward launched K7 {k7['K7']} "
                             "times")
    log(f"[train check] flash build under autograd on the card raised "
        f"NoBackwardError ({refused[:90]}...); under no_grad its forward "
        f"launched K7 {k7['K7']} times (once per layer)")


def train_phase(runs, dev) -> None:
    """Training on the card: qwen2-1.5b at full width and depth through
    ``repro_torch.Trainer`` and ``make_train_step`` (bf16 params, float32
    master weights and moments, remat "dots", TRAIN_MICRO microbatches),
    TRAIN_STEPS steps on one repeated TokenStream batch, one of them
    profiled; its launch counts go to ``runs["train"]`` (K7 must stay at
    0). The checks run earlier (``train_side_checks``)."""
    import math

    import repro_torch
    from repro_torch.models.params import init_params, tree_leaves
    from repro_torch.train.optimizer import adamw_init
    cfg = train_config()
    model = repro_torch.build_model(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(model.param_specs(),
                         torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    condition_attention(params, model.dims, cfg.d_model)
    state = {"params": params, "opt": adamw_init(params)}
    del params
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(x.numel() for x in tree_leaves(state["params"]))
    state_bytes = sum(x.numel() * x.element_size()
                      for x in tree_leaves(state))
    batch = repro_torch.TokenStream(cfg.vocab_size, TRAIN_SEQS, TRAIN_LEN,
                                    seed=0, device=dev).batch_at(0)
    step = repro_torch.make_train_step(
        model, repro_torch.AdamWConfig(lr=TRAIN_LR, warmup_steps=1),
        microbatches=TRAIN_MICRO)
    steps = []

    def timed_step(st, b):
        torch.cuda.synchronize()
        t = time.perf_counter()
        st, met = step(st, b)
        torch.cuda.synchronize()
        steps.append(dict(s=time.perf_counter() - t, **{
            k: float(met[k]) for k in ("loss", "grad_norm", "lr", "ce")}))
        return st, met

    trainer = repro_torch.Trainer(timed_step, lambda s: batch)
    (state, _, done), runs["train"] = counted(
        lambda: trainer.run(state, 0, TRAIN_STEPS))
    peak = torch.cuda.max_memory_allocated()
    tokens = TRAIN_SEQS * TRAIN_LEN
    warm = min(r["s"] for r in steps[1:])
    tok_s = tokens / warm
    mfu = 6 * n_params * tok_s / BF16_OPS_PER_S
    for i, r in enumerate(steps):
        log(f"[train] step {i + 1}: loss={r['loss']:.5f} ce={r['ce']:.5f} "
            f"grad_norm={r['grad_norm']:.4f} lr={r['lr']:.3e} "
            f"s={r['s']:.3f}")
    losses = [r["loss"] for r in steps]
    ln_v = math.log(cfg.vocab_size)
    if (done != TRAIN_STEPS or not all(map(math.isfinite, losses))
            or abs(losses[0] - ln_v) > TRAIN_FIRST_LOSS_SLACK
            or not losses[-1] < losses[0] or runs["train"]["K7"] != 0):
        raise AssertionError(f"training: losses {losses} (ln V = {ln_v:.3f})"
                             f", K7 launches {runs['train']['K7']}")
    log(f"[train] {cfg.name} layers={cfg.n_layers} d_model={cfg.d_model} "
        f"params={n_params} state_bytes={state_bytes} init_s={init_s:.3f} "
        f"remat={cfg.remat} attn_impl={cfg.attn_impl} batch={TRAIN_SEQS}x"
        f"{TRAIN_LEN} microbatches={TRAIN_MICRO} tokens_per_step={tokens} "
        f"first_step_s={steps[0]['s']:.3f} warm_step_s={warm:.3f} "
        f"tokens_per_s={tok_s:.0f} model_flops_per_s={6 * n_params * tok_s:.4e}"
        f" (6 N tokens/s) mfu_of_989_tflops={mfu:.4f} max_memory_allocated="
        f"{peak} first_loss={losses[0]:.4f} (ln V = {ln_v:.4f}) last_loss="
        f"{losses[-1]:.4f} launches={runs['train']}")
    prof = device_profile(lambda: timed_step(state, batch),
                          ("gemm", "nvjet", "cutlass"))
    log_profile(f"train step ({TRAIN_MICRO} microbatches)", prof, "gemm")
    log(f"[train] device_busy_s={prof[1]:.3f} of the unprofiled warm step's "
        f"{warm:.3f} s: busy_share={prof[1] / warm:.4f} (the profiler's own "
        f"host work stretches its wall to {prof[0]:.3f} s)")
    del state, batch, trainer, step
    torch.cuda.empty_cache()


def train_config():
    """qwen2-1.5b at full width and depth for training: plain attention
    (K7 has no backward), remat "dots"."""
    import dataclasses

    import repro_torch
    return dataclasses.replace(repro_torch.get_config(TRAIN_ARCH),
                               attn_impl="jnp", remat="dots")


def train_side_checks(dev) -> None:
    """The training phase's untimed half: the kill-and-resume children
    start, ``train_checks`` runs meanwhile, then the resumed child."""
    t0 = time.perf_counter()
    started = train_children()
    try:
        train_checks(train_config(), dev)
    except BaseException:
        for proc in started["procs"].values():
            proc.kill()
        raise
    log(f"[train kill] {train_resume(started)}")
    log(f"[train check] s={time.perf_counter() - t0:.3f}")


def last_logits_rel_l2(model, plain, params, toks) -> float:
    """Relative L2 distance of the two builds' last-token prefill logits
    (``plain``'s as the reference)."""
    with torch.inference_mode():
        lf = model.prefill(params, toks, LLM_CACHE)[0][:, -1].float()
        lp = plain.prefill(params, toks, LLM_CACHE)[0][:, -1].float()
    return float((lf - lp).norm() / lp.norm())


def ops_call(label, dataset, device=None):
    """One of item 13's one-call wrappers (``kernels/ops.py``) on the
    measures data at Jaccard t = OPS_T, S sorted by size, Lemma-3.1
    windows -> (pair digest, stats). ``bitmap`` and ``onehot`` take the
    two sides' bitmaps (K2, K4 on the card); ``lfvt`` / ``lfvt_ref`` the
    S side's FlatLFVT and R's padded lists (K1; the whole-block walk);
    ``walk_mask`` is ``lfvt_walk_join_mask`` (K1), its mask's pairs."""
    from repro_torch.core.tile_join import window_bounds
    from repro_torch.kernels import ops
    dev = torch.device(device or "cuda")
    R, S = measures_data(dataset)
    Ss = S.sort_by_size()
    lo, hi = window_bounds(R.sizes(), Ss.sizes(), OPS_T, "jaccard")
    if label in ("bitmap", "onehot"):
        W = (max(R.universe, Ss.universe) + 31) // 32
        args = (torch.tensor(R.bitmaps(W).view(np.int32), device=dev),
                R.sizes().astype(np.int32),
                torch.tensor(Ss.bitmaps(W).view(np.int32), device=dev),
                Ss.sizes().astype(np.int32), lo, hi)
    else:
        r_pad, r_sz = R.padded()
        args = (Ss.flat_lfvt(), torch.tensor(r_pad, device=dev), r_sz, lo,
                hi)
    st: dict = {}
    if label == "walk_mask":
        rows, cols = np.nonzero(ops.lfvt_walk_join_mask(*args, OPS_T,
                                                        stats=st))
    else:
        pairs, n = ops.join_pairs(label, *args, OPS_T, stats=st)
        rows, cols = pairs[:n].cpu().numpy().T
    return pair_digest(rows, cols), {k: st.get(k) for k in OPS_STATS}


def cpu_ops_call(task):
    """Pool worker: ``ops_call`` on the CPU -> (its result, seconds)."""
    t0 = time.perf_counter()
    out = ops_call(*task, device="cpu")
    return out, time.perf_counter() - t0


def ops_compare(ops_async) -> None:
    """Item 13's wrappers on the card (K2, K4, K1 launched) against the
    CPU workers': equal pairs and stats."""
    t0 = time.perf_counter()
    card = []
    for label, dataset in OPS_CALLS:
        out, launches = counted(lambda: ops_call(label, dataset))
        want = {"bitmap": "K2", "onehot": "K4", "lfvt": "K1",
                "walk_mask": "K1"}.get(label)
        if want and launches[want] <= 0:
            raise AssertionError(f"ops {label} never launched {want}")
        card.append((out, launches))
    card_s = time.perf_counter() - t0
    cpu = ops_async.get()
    for (label, dataset), (got, launches), (want, sec) in zip(
            OPS_CALLS, card, cpu):
        if got != want:
            raise AssertionError(f"ops {label} on {dataset}: card {got} "
                                 f"vs cpu {want}")
        log(f"[ops] {label} ({dataset}, jaccard t={OPS_T}) card == cpu: "
            f"pairs={got[0][0]} stats={json.dumps(got[1])} "
            f"launches={ {k: n for k, n in launches.items() if n} } "
            f"cpu_worker_s={sec:.3f}")
    log(f"[ops] card side s={card_s:.3f}")


class RouteLog:
    """Stands in for ``models.moe.route``: records each call's top-k
    experts and, with ``replay`` set (the calls of another run, in
    order), routes to those experts instead, weighting them by this
    run's own renormalised probabilities. Top-k is discontinuous: a near
    tie that bf16 rounding flips is not the attention kernel's error, so
    the flash and plain MoE builds are compared under one routing."""

    def __init__(self, route, replay=None):
        self.route, self.replay, self.calls = route, replay, []

    def __call__(self, router, xt, moe_cfg, n_experts, **kw):
        probs, top_w, top_e = self.route(router, xt, moe_cfg, n_experts, **kw)
        self.calls.append(top_e)
        if self.replay is not None:
            top_e = self.replay[len(self.calls) - 1]
            w = probs.gather(1, top_e)
            top_w = w / w.sum(dim=-1, keepdim=True)
        return probs, top_w, top_e


def routed_alike(a, b) -> float:
    """Share of (token, layer) top-k sets two runs' ``RouteLog``s hold in
    common."""
    same = sum(int((x.sort(dim=-1).values == y.sort(dim=-1).values)
                   .all(dim=-1).sum()) for x, y in zip(a, b))
    return same / sum(x.shape[0] for x in a)


def family_run(name, layers, batch, prompt, new, runs, dev):
    """Serve one arch on the card: seeded bf16 weights made there, an
    ``attn_impl="flash"`` build against an ``attn_impl="jnp"`` one on the
    same weights; the counted prefill's launches go to
    ``runs["family " + name]``."""
    import dataclasses

    import repro_torch
    from repro_torch.models import moe
    from repro_torch.models.frontend import make_frontend_stub
    from repro_torch.models.params import init_params, tree_leaves
    cfg = dataclasses.replace(repro_torch.get_config(name),
                              attn_impl="flash")
    full_layers = cfg.n_layers
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    model = repro_torch.build_model(cfg)
    plain = repro_torch.build_model(dataclasses.replace(cfg,
                                                        attn_impl="jnp"))
    n_attn = cfg.layer_kinds().count("attn")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    params = init_params(model.param_specs(),
                         torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    if n_attn:
        condition_attention(params, model.dims, cfg.d_model)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t_phase
    n_params = sum(x.numel() for x in tree_leaves(params))
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (batch, prompt)).astype(
        np.int32)
    toks = torch.from_numpy(prompts).to(dev)
    extra = make_frontend_stub(cfg, batch, rng, device=dev).get(
        "extra_embeds")
    n_stub = 0 if extra is None else extra.shape[1]
    cache = n_stub + prompt + new
    label = f"family {name}"

    def prefill(m):
        with torch.inference_mode():
            return m.prefill(params, toks, cache, extra_embeds=extra)

    def serve():
        """Prefill, then greedy decode: the engine, or the same loop
        by hand where the stub embeddings go in (the engine takes
        tokens only)."""
        if extra is None:
            return repro_torch.ServeEngine(model, params, max_seq_len=cache
                                           ).generate(prompts, new)
        with torch.inference_mode():
            logits, state = prefill(model)
            out = [logits[:, -1].argmax(dim=-1).int()[:, None]]
            for step in range(new - 1):
                logits, state = model.decode_step(
                    params, out[-1], n_stub + prompt + step, state)
                out.append(logits[:, -1].argmax(dim=-1).int()[:, None])
        return torch.cat(out, dim=1).cpu().numpy()

    prefill(model)   # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, runs[label] = counted(lambda: prefill(model))
    prefill_s = time.perf_counter() - t0
    if runs[label]["K7"] != n_attn:
        raise AssertionError(f"{name}: the prefill launched K7 "
                             f"{runs[label]['K7']} times, not once per "
                             f"attention layer ({n_attn})")
    t0 = time.perf_counter()
    out, gen_runs = counted(serve)
    gen_s = time.perf_counter() - t0
    if (out.shape != (batch, new) or out.min() < 0
            or out.max() >= cfg.vocab_size or gen_runs["K7"] != n_attn):
        raise AssertionError(f"{name}: generated {out.shape} tokens in "
                             f"[{out.min()}, {out.max()}], K7 launches "
                             f"{gen_runs['K7']}")
    peak = torch.cuda.max_memory_allocated()

    # flash against plain attention on the same weights; the MoE builds
    # under the flash build's routing (RouteLog), their own routing's
    # agreement logged
    route = moe.route
    note = ""
    try:
        if cfg.moe is not None:
            moe.route = flash_log = RouteLog(route)
            lf = prefill(model)[0][:, -1].float()
            moe.route = own_log = RouteLog(route)
            free = prefill(plain)[0][:, -1].float()
            moe.route = RouteLog(route, replay=flash_log.calls)
            lp = prefill(plain)[0][:, -1].float()
            note = (f" routed_alike={routed_alike(flash_log.calls, own_log.calls):.5f}"
                    f" ((token, layer) top-{cfg.moe.top_k} sets, own "
                    f"routing) own_routing_max_err_over_max_logit="
                    f"{float(((lf - free).abs().amax(dim=-1) / free.abs().amax(dim=-1)).max()):.4f}")
        else:
            lf = prefill(model)[0][:, -1].float()
            lp = prefill(plain)[0][:, -1].float()
    finally:
        moe.route = route
    if not (torch.isfinite(lf).all() and torch.isfinite(lp).all()):
        raise AssertionError(f"{name}: the prefill logits are not finite")
    err = (lf - lp).abs().amax(dim=-1)
    tol = LLM_LOGIT_TOL * lp.abs().amax(dim=-1)
    if (err > tol).any():
        raise AssertionError(f"{name}: flash and plain prefill logits "
                             f"differ by {err.tolist()} (tolerance "
                             f"{tol.tolist()})")
    wall = time.perf_counter() - t_phase
    log(f"[family {name}] family={cfg.family} layers={cfg.n_layers}"
        f"{'' if layers is None else f' of {full_layers}'} kinds="
        f"{ {k: cfg.layer_kinds().count(k) for k in dict.fromkeys(cfg.layer_kinds())} } "
        f"d_model={cfg.d_model} heads={cfg.n_heads} kv_heads="
        f"{cfg.n_kv_heads} head_dim={cfg.resolved_head_dim} window="
        f"{cfg.window} params={n_params} weight_bytes={2 * n_params} "
        f"init_s={init_s:.3f} prompts={batch}x{prompt}"
        f"{f'+{n_stub} stub' if n_stub else ''} new_tokens={new} "
        f"prefill_s={prefill_s:.4f} generate_s={gen_s:.3f} "
        f"decode_ms_per_step={(gen_s - prefill_s) / max(new - 1, 1) * 1e3:.2f} "
        f"max_memory_allocated={peak} launches={runs[label]}; flash vs "
        f"plain last-token logits max_err_over_max_logit="
        f"{float((err / lp.abs().amax(dim=-1)).max()):.4f} (tolerance "
        f"{LLM_LOGIT_TOL}){note} wall_s={wall:.3f}")
    del params, toks, extra, lf, lp
    torch.cuda.empty_cache()
    return wall, peak


def families_phase(runs, dev) -> None:
    """Serve every other family on the card (``FAMILY_RUNS``), each model
    freed before the next."""
    t0 = time.perf_counter()
    walls = {}
    for name, layers, batch, prompt, new in FAMILY_RUNS:
        walls[name] = family_run(name, layers, batch, prompt, new, runs,
                                 dev)
    log(f"[families] phase_s={time.perf_counter() - t0:.3f} (wall_s, "
        f"peak bytes) per arch: {json.dumps(walls)}")


def coll_line(snap, per: int = 1) -> str:
    """A collective counter snapshot as bytes and calls per kind, each
    divided by ``per``."""
    return " ".join(f"{k}={snap['bytes'][k] // per}B/{snap['calls'][k] // per}"
                    for k in snap["bytes"])


def logits_agree(label, lf, lo):
    """``lf`` within ``LLM_LOGIT_TOL`` of ``lo``'s largest |logit| in each
    row (last-token logits, float32) -> the largest error over it."""
    if not (torch.isfinite(lf).all() and torch.isfinite(lo).all()):
        raise AssertionError(f"{label}: the logits are not finite")
    err = (lf - lo).abs().amax(dim=-1)
    scale = lo.abs().amax(dim=-1)
    if (err > LLM_LOGIT_TOL * scale).any():
        raise AssertionError(f"{label}: logits differ by {err.tolist()} "
                             f"(tolerance {LLM_LOGIT_TOL} x {scale.tolist()})")
    return float((err / scale).max())


def par_serve(runs, dev) -> None:
    """qwen2-1.5b at full width and depth, the flash build at tp = 2, on
    two model slots of the card behind ``ServeEngine``; K7 once per slot
    per layer; against the same weights unsharded (one slot, tp = 2)."""
    import dataclasses

    import repro_torch
    from repro_torch.models.params import init_params
    from repro_torch.sharding import counter, unshard
    cfg = dataclasses.replace(repro_torch.get_config(LLM_ARCH),
                              attn_impl="flash")
    mesh = repro_torch.make_host_mesh(1, model=2)
    par = repro_torch.build_model(cfg, 2, mesh=mesh)
    one = repro_torch.build_model(cfg, 2)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(one.param_specs(),
                         torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    condition_attention(params, one.dims, cfg.d_model)
    placed = par.place(params)
    slot_heads = [(sd.n_heads_p, sd.n_kv) for sd, _ in par.layout.attn]
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (LLM_BATCH, LLM_PROMPT)).astype(np.int32)
    toks = torch.from_numpy(prompts).to(dev)
    eng = repro_torch.ServeEngine(par, placed, max_seq_len=LLM_CACHE)
    t0 = time.perf_counter()
    eng.generate(prompts, 1)
    cold_s = time.perf_counter() - t0
    counter.reset()
    t0 = time.perf_counter()
    first, runs["tp2 prefill"] = counted(lambda: eng.generate(prompts, 1))
    prefill_s = time.perf_counter() - t0
    c_pre = counter.snapshot()
    if runs["tp2 prefill"]["K7"] != 2 * cfg.n_layers:
        raise AssertionError(f"the tp=2 prefill launched K7 "
                             f"{runs['tp2 prefill']['K7']} times, not once "
                             f"per slot per layer ({2 * cfg.n_layers})")
    counter.reset()
    t0 = time.perf_counter()
    out, gen_runs = counted(lambda: eng.generate(prompts, PAR_SERVE_NEW))
    gen_s = time.perf_counter() - t0
    c_gen = counter.snapshot()
    peak = torch.cuda.max_memory_allocated()
    if (out.shape != (LLM_BATCH, PAR_SERVE_NEW) or out.min() < 0
            or out.max() >= cfg.vocab_size
            or not np.array_equal(out[:, :1], first)):
        raise AssertionError(f"tp=2 generate gave {out.shape} tokens in "
                             f"[{out.min()}, {out.max()}]")
    steps = PAR_SERVE_NEW - 1
    c_dec = {k: {kind: c_gen[k][kind] - c_pre[k][kind]
                 for kind in c_gen[k]} for k in ("bytes", "calls")}
    decode_s = gen_s - prefill_s
    with torch.inference_mode():
        lf = unshard(par.prefill(placed, toks, LLM_CACHE)[0])[:, -1].float()
        lo = one.prefill(params, toks, LLM_CACHE)[0][:, -1].float()
    worst = logits_agree("tp=2 sharded vs one slot", lf, lo)
    rec = GapRecorder(one)
    want = repro_torch.ServeEngine(rec, params, max_seq_len=LLM_CACHE
                                   ).generate(prompts, PAR_SERVE_NEW)
    gaps = np.stack(rec.gaps, axis=1)
    margin = LLM_LOGIT_TOL * np.stack(rec.scale, axis=1)
    compared = []
    for i in range(LLM_BATCH):
        k = 0
        while k < PAR_SERVE_NEW and gaps[i, k] > margin[i, k]:
            k += 1
        if not np.array_equal(out[i, :k], want[i, :k]):
            raise AssertionError(f"tp=2 stream {i}: greedy tokens differ "
                                 f"from one slot's within {k} steps")
        compared.append(k)
    log(f"[parallel serve] {cfg.name} tp=2 on mesh {mesh.shape} (slots on "
        f"{sorted({str(d) for d in mesh.devices})}), flash, slot (query, "
        f"KV) heads={slot_heads}; prompts={LLM_BATCH}x{LLM_PROMPT} "
        f"new_tokens={PAR_SERVE_NEW} cold_prefill_s={cold_s:.3f} "
        f"prefill_s={prefill_s:.4f} generate_s={gen_s:.3f} "
        f"decode_ms_per_step={decode_s / steps * 1e3:.2f} "
        f"max_memory_allocated={peak} launches={runs['tp2 prefill']}; "
        f"collectives a prefill: {coll_line(c_pre)}; a decode step: "
        f"{coll_line(dict(c_dec, total=0), steps)}; last-token logits vs "
        f"one slot max_err_over_max_logit={worst:.4f} (tolerance "
        f"{LLM_LOGIT_TOL}); greedy tokens equal for compared_steps="
        f"{compared} of {PAR_SERVE_NEW}; streams_equal_in_full="
        f"{int((out == want).all(axis=1).sum())}/{LLM_BATCH}")
    with torch.inference_mode():
        state = par.prefill(placed, toks, LLM_CACHE)[1]
        tok = torch.from_numpy(out[:, :1]).to(dev)

        def decode_steps():
            for step in range(DECODE_PROFILED):
                par.decode_step(placed, tok, LLM_PROMPT + step, state)
        prof = device_profile(decode_steps, K7_KERNEL_NAMES)
    log_profile(f"tp=2 decode ({DECODE_PROFILED} decode_steps)", prof, "K7")
    del eng, params, placed, rec, lf, lo, state
    torch.cuda.empty_cache()


def par_padded(runs, dev) -> None:
    """qwen2-1.5b built at tp = 16 on one slot: 12 query heads padded to
    16 on the 2 KV heads (group 8), the cache repeated to 16 heads; the
    flash prefill (K7 at group 8) against the plain prefill of the same
    padded build."""
    import dataclasses

    import repro_torch
    from repro_torch.models.params import init_params
    tp = PAR_PADDED_TP
    cfg = dataclasses.replace(repro_torch.get_config(LLM_ARCH),
                              attn_impl="flash")
    model = repro_torch.build_model(cfg, tp)
    plain = repro_torch.build_model(dataclasses.replace(cfg,
                                                        attn_impl="jnp"), tp)
    d = model.dims
    if (d.n_heads_p, d.n_kv_cache) != (16, 16):
        raise AssertionError(f"tp={tp} dims {d}")
    torch.cuda.empty_cache()
    params = init_params(model.param_specs(),
                         torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    condition_attention(params, d, cfg.d_model)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (LLM_BATCH, LLM_PROMPT)).astype(np.int32)).to(dev)
    with torch.inference_mode():
        model.prefill(params, toks, LLM_PROMPT)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, runs[f"tp{tp} prefill"] = counted(
            lambda: model.prefill(params, toks, LLM_PROMPT)[0])
        prefill_s = time.perf_counter() - t0
        lf = lg[:, -1].float()
        lp = plain.prefill(params, toks, LLM_PROMPT)[0][:, -1].float()
    if runs[f"tp{tp} prefill"]["K7"] != cfg.n_layers:
        raise AssertionError(f"the tp={tp} prefill launched K7 "
                             f"{runs[f'tp{tp} prefill']['K7']} times")
    worst = logits_agree(f"tp={tp} flash vs plain", lf, lp)
    log(f"[parallel padded] {cfg.name} built at tp={tp} on one slot: "
        f"heads {d.n_heads} padded to {d.n_heads_p} on {d.n_kv} KV heads "
        f"(K7 group {d.n_heads_p // d.n_kv}), cache heads {d.n_kv_cache}; "
        f"prompts={LLM_BATCH}x{LLM_PROMPT} prefill_s={prefill_s:.4f} "
        f"launches={runs[f'tp{tp} prefill']}; flash vs plain last-token "
        f"logits max_err_over_max_logit={worst:.4f} (tolerance "
        f"{LLM_LOGIT_TOL})")
    del params, lg, lf, lp
    torch.cuda.empty_cache()


def par_experts(runs, dev) -> None:
    """qwen2-moe-a2.7b at full width, PAR_MOE_LAYERS of 24 layers, its 60
    experts split over four model slots (15 each), the flash build: the
    sharded prefill against the unsharded (one slot, tp = 4) under one
    routing (``RouteLog`` replays the unsharded run's top-k), the routing
    of its own logged."""
    import dataclasses

    import repro_torch
    from repro_torch.models import moe
    from repro_torch.models.params import init_params
    from repro_torch.sharding import counter, unshard
    cfg = dataclasses.replace(repro_torch.get_config(PAR_MOE_ARCH),
                              attn_impl="flash", n_layers=PAR_MOE_LAYERS)
    mesh = repro_torch.make_host_mesh(1, model=4)
    par = repro_torch.build_model(cfg, 4, mesh=mesh)
    one = repro_torch.build_model(cfg, 4)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(one.param_specs(),
                         torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    condition_attention(params, one.dims, cfg.d_model)
    placed = par.place(params)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (PAR_MOE_BATCH, LLM_PROMPT)).astype(np.int32)
    ).to(dev)

    def prefill(m, p):
        with torch.inference_mode():
            lg = m.prefill(p, toks, LLM_PROMPT)[0]
        return (unshard(lg) if m is par else lg)[:, -1].float()
    prefill(par, placed)
    counter.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, runs["ep prefill"] = counted(lambda: prefill(par, placed))
    prefill_s = time.perf_counter() - t0
    c_pre = counter.snapshot()
    if runs["ep prefill"]["K7"] != 4 * cfg.n_layers:
        raise AssertionError(f"the expert-parallel prefill launched K7 "
                             f"{runs['ep prefill']['K7']} times")
    peak = torch.cuda.max_memory_allocated()
    route = moe.route
    try:
        moe.route = one_log = RouteLog(route)
        lo = prefill(one, params)
        moe.route = own_log = RouteLog(route)
        free = prefill(par, placed)
        moe.route = RouteLog(route, replay=one_log.calls)
        lf = prefill(par, placed)
    finally:
        moe.route = route
    worst = logits_agree("expert-parallel vs one slot", lf, lo)
    log(f"[parallel experts] {cfg.name} layers={cfg.n_layers} of 24 "
        f"experts={cfg.moe.n_experts} (padded {par.n_experts_p}) over "
        f"mesh {mesh.shape}: {list(par.layout.experts)} (first, count) "
        f"a slot; prompts={PAR_MOE_BATCH}x{LLM_PROMPT} prefill_s="
        f"{prefill_s:.4f} max_memory_allocated={peak} launches="
        f"{runs['ep prefill']}; collectives a prefill: {coll_line(c_pre)}; "
        f"vs one slot under one routing max_err_over_max_logit="
        f"{worst:.4f} (tolerance {LLM_LOGIT_TOL}); own routing "
        f"routed_alike={routed_alike(one_log.calls, own_log.calls):.5f} "
        f"max_err_over_max_logit="
        f"{float(((free - lo).abs().amax(-1) / lo.abs().amax(-1)).max()):.4f}")
    del params, placed, lo, lf, free
    torch.cuda.empty_cache()


def par_train_run(step, state, batch, steps=PAR_TRAIN_STEPS):
    """``steps`` steps -> (state, per step: s, collectives, loss, lr,
    grad_norm)."""
    from repro_torch.sharding import counter
    out = []
    for _ in range(steps):
        counter.reset()
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, met = step(state, batch)
        torch.cuda.synchronize()
        out.append(dict(s=time.perf_counter() - t, coll=counter.snapshot(),
                        **{k: float(met[k]) for k in ("loss", "lr",
                                                      "grad_norm")}))
    return state, out


def par_train_weights(model, cfg, dev):
    from repro_torch.models.params import init_params
    p = init_params(model.param_specs(),
                    torch.Generator(device=dev).manual_seed(0), device=dev)
    condition_attention(p, model.dims, cfg.d_model)
    return p


def par_train_reference(dev):
    """The single-slot step at 2 x PAR_TRAIN_MICRO microbatches on the
    phase's batch and weights -> (cfg, opt, batch, per-step readings,
    the master weights on the host, peak bytes)."""
    import repro_torch
    from repro_torch.models.params import tree_leaves
    from repro_torch.train.optimizer import adamw_init
    cfg = train_config()
    opt = repro_torch.AdamWConfig(lr=TRAIN_LR, warmup_steps=1)
    batch = repro_torch.TokenStream(cfg.vocab_size, TRAIN_SEQS, TRAIN_LEN,
                                    seed=0, device=dev).batch_at(0)
    one = repro_torch.build_model(cfg, 2)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    p = par_train_weights(one, cfg, dev)
    state = {"params": p, "opt": adamw_init(p)}
    del p
    (state, ref), _ = counted(lambda: par_train_run(
        repro_torch.make_train_step(one, opt,
                                    microbatches=2 * PAR_TRAIN_MICRO),
        state, batch))
    peak = torch.cuda.max_memory_allocated()
    master = [x.cpu() for x in tree_leaves(state["opt"]["master"])]
    del state
    torch.cuda.empty_cache()
    return cfg, opt, batch, ref, master, peak


def par_train_sharded(runs, dev, cfg, opt, batch):
    """The (data, model) = (2, 2) ZeRO-1 run on the same batch and
    weights -> (mesh, state, per-step readings, peak bytes, allocator
    retries, the step); its launches go to ``runs``."""
    import repro_torch
    from repro_torch.train.parallel import place_train_state
    mesh = repro_torch.make_host_mesh(2, model=2)
    par = repro_torch.build_model(cfg, 2, mesh=mesh)
    torch.cuda.reset_peak_memory_stats()
    retries0 = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    state = place_train_state(par, params=par.place(par_train_weights(
        par, cfg, dev)))
    torch.cuda.synchronize()
    step = repro_torch.make_train_step(par, opt,
                                       microbatches=PAR_TRAIN_MICRO)
    (state, got), runs["tp2 dp2 train"] = counted(
        lambda: par_train_run(step, state, batch))
    peak = torch.cuda.max_memory_allocated()
    retries = torch.cuda.memory_stats().get("num_alloc_retries",
                                            0) - retries0
    return mesh, state, got, peak, retries, step


def par_train_readings(state, got, ref, master) -> dict:
    """The sharded run against the single slot's: per step the loss's
    and the grad norm's relative differences; over the master weights
    the largest difference and the mean, the share within
    PAR_MEDIAN_TOL x the last step's lr (the median is within it iff
    the share is at least one half), and the median and 99.9th
    percentile of every PAR_SAMPLE_STRIDE-th difference, over that lr."""
    from repro_torch.models.params import tree_leaves
    from repro_torch.sharding import unshard
    lr = ref[-1]["lr"]
    tol = PAR_MEDIAN_TOL * lr
    worst, total, within, n, sample = 0.0, 0.0, 0, 0, []
    for x, w in zip(tree_leaves(state["opt"]["master"]), master):
        d = (unshard(x).cpu() - w).abs().ravel()
        worst = max(worst, float(d.max()))
        total += float(d.sum(dtype=torch.float64))
        within += int((d <= tol).sum())
        n += d.numel()
        sample.append(d[::PAR_SAMPLE_STRIDE])
    q50, q999 = np.quantile(torch.cat(sample).double().numpy(), [0.5, 0.999])
    return {"loss": [abs(a["loss"] - b["loss"]) / abs(b["loss"])
                     for a, b in zip(got, ref)],
            "grad_norm": [abs(a["grad_norm"] - b["grad_norm"])
                          / b["grad_norm"] for a, b in zip(got, ref)],
            "finite": all(np.isfinite([a["loss"], a["grad_norm"]]).all()
                          for a in got),
            "max_abs": worst, "mean_abs": total / n,
            "flip_bound": PAR_FLIPS * sum(r["lr"] for r in ref),
            "within_median_tol": within / n,
            "median_over_lr": float(q50) / lr,
            "p999_over_lr": float(q999) / lr}


def par_train_faults(r) -> list:
    """What the readings of ``par_train_readings`` fail, as messages."""
    bad = []
    if not r["finite"]:
        bad.append("a loss or grad norm is not finite")
    for i, (el, eg) in enumerate(zip(r["loss"], r["grad_norm"])):
        if el > PAR_LOSS_TOL:
            bad.append(f"step {i + 1}: loss {el:.3e} relative from one "
                       f"slot's (tolerance {PAR_LOSS_TOL})")
        if eg > PAR_GNORM_TOL:
            bad.append(f"step {i + 1}: grad norm {eg:.3e} relative from "
                       f"one slot's (tolerance {PAR_GNORM_TOL})")
    if r["max_abs"] > r["flip_bound"]:
        bad.append(f"master weights {r['max_abs']:.3e} from one slot's "
                   f"(bound {r['flip_bound']:.3e})")
    if r["within_median_tol"] < 0.5:
        bad.append(f"the median master difference is above "
                   f"{PAR_MEDIAN_TOL} x lr (share within "
                   f"{r['within_median_tol']:.4f})")
    return bad


def par_train_line(r) -> str:
    return (f"master weights vs one slot max_abs_err={r['max_abs']:.3e} "
            f"(bound {r['flip_bound']:.3e} = {PAR_FLIPS} x the steps' lrs) "
            f"mean_abs_err={r['mean_abs']:.3e} median/lr="
            f"{r['median_over_lr']:.4f} p99.9/lr={r['p999_over_lr']:.4f} "
            f"share_within_{PAR_MEDIAN_TOL}xlr={r['within_median_tol']:.4f} "
            f"(at least 0.5); relative loss differences "
            f"{[f'{x:.2e}' for x in r['loss']]} (tolerance {PAR_LOSS_TOL}), "
            f"grad norm {[f'{x:.2e}' for x in r['grad_norm']]} (tolerance "
            f"{PAR_GNORM_TOL})")


def par_train(runs, dev) -> None:
    """qwen2-1.5b at full width and depth trained on (data, model) =
    (2, 2) slots of the card: ZeRO-1, remat "dots", plain attention,
    PAR_TRAIN_STEPS steps on one batch of TRAIN_SEQS x TRAIN_LEN tokens
    (each data slot TRAIN_SEQS / 2 rows as PAR_TRAIN_MICRO
    microbatches), against the single-slot step at 2 x PAR_TRAIN_MICRO
    microbatches on the same batch and weights."""
    cfg, opt, batch, ref, master, ref_peak = par_train_reference(dev)
    mesh, state, got, peak, retries, step = par_train_sharded(
        runs, dev, cfg, opt, batch)
    r = par_train_readings(state, got, ref, master)
    for i, (a, b) in enumerate(zip(got, ref)):
        log(f"[parallel train] step {i + 1}: loss={a['loss']:.5f} (one slot "
            f"{b['loss']:.5f}) grad_norm={a['grad_norm']:.4f} (one slot "
            f"{b['grad_norm']:.4f}) s={a['s']:.3f} (one slot {b['s']:.3f}) "
            f"collectives: {coll_line(a['coll'])}")
    bad = par_train_faults(r)
    if bad:
        raise AssertionError("sharded training vs one slot: "
                             + "; ".join(bad))
    warm = min(x["s"] for x in got[1:])
    tokens = TRAIN_SEQS * TRAIN_LEN
    if runs["tp2 dp2 train"]["K7"] != 0:
        raise AssertionError("training launched K7")
    log(f"[parallel train] {cfg.name} layers={cfg.n_layers} on mesh "
        f"{mesh.shape}: ZeRO-1, remat={cfg.remat}, attn_impl="
        f"{cfg.attn_impl}, batch={TRAIN_SEQS}x{TRAIN_LEN}, "
        f"{PAR_TRAIN_MICRO} microbatches a data slot; warm_step_s="
        f"{warm:.3f} tokens_per_s={tokens / warm:.0f} max_memory_allocated="
        f"{peak} num_alloc_retries={retries} (one slot at "
        f"{2 * PAR_TRAIN_MICRO} microbatches: warm_step_s="
        f"{min(x['s'] for x in ref[1:]):.3f} max_memory_allocated="
        f"{ref_peak}); {par_train_line(r)}")
    # one more step profiled: the device's work against the one slot's
    # (the training phase's profiled step, same batch and microbatches)
    log_profile("sharded train step (2 x 2 slots)", device_profile(
        lambda: step(state, batch), ("gemm", "nvjet", "cutlass")), "gemm")
    del state, master, batch, step
    torch.cuda.empty_cache()


def parallel_phase(runs, dev) -> None:
    """Phase 6d: tensor, expert and data parallelism over the port's
    mesh, every slot on the one card."""
    t0 = time.perf_counter()
    parts = {}
    for fn in (par_serve, par_padded, par_experts, par_train):
        t = time.perf_counter()
        fn(runs, dev)
        parts[fn.__name__] = round(time.perf_counter() - t, 3)
    log(f"[parallel] phase_s={time.perf_counter() - t0:.3f} parts_s="
        f"{json.dumps(parts)}")


def f32_decode(model, params, toks, cache, new):
    """Prefill and ``new - 1`` greedy decode steps in float32 -> (per step
    the last-token logits on the host, float32, (B, V); the tokens,
    (B, new))."""
    from repro_torch.models.parallel import greedy_tokens
    from repro_torch.sharding import Sharded, unshard
    outs, tokens = [], []
    with torch.inference_mode():
        logits, state = model.prefill(params, toks, cache,
                                      dtype=torch.float32)
        for step in range(new):
            sharded = isinstance(logits, Sharded)
            last = (unshard(logits) if sharded else logits)[:, -1].float()
            tok = (greedy_tokens(logits) if sharded
                   else last.argmax(dim=-1).to(torch.int32))
            outs.append(last.cpu())
            tokens.append(tok.cpu())
            if step < new - 1:
                logits, state = model.decode_step(
                    params, tok[:, None], toks.shape[1] + step, state)
    return outs, torch.stack(tokens, dim=1).numpy()


def state_serve(name, batch, prompt, runs, dev) -> None:
    """One state-axis family at full width and depth, tp = 2 on (data,
    model) = (1, 2) slots of the card, its recurrent weights split over
    the two: served in bf16 behind ``ServeEngine`` (prefill, decode, K7
    once per slot per attention layer, collectives), and held against
    the same weights on one slot at tp = 2 in float32 (the prefill's and
    every decode step's last-token logits within STATE_F32_TOL, greedy
    tokens equal while the one slot's top-2 gap exceeds it); the bf16
    runs' difference is logged beside it."""
    import dataclasses

    import repro_torch
    from repro_torch.models.params import init_params, tree_map
    from repro_torch.sharding import counter, unshard
    cfg = dataclasses.replace(repro_torch.get_config(name),
                              attn_impl="flash")
    mesh = repro_torch.make_host_mesh(1, model=2)
    par = repro_torch.build_model(cfg, 2, mesh=mesh)
    one = repro_torch.build_model(cfg, 2)
    n_attn = cfg.layer_kinds().count("attn")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(one.param_specs(),
                         torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    if n_attn:
        condition_attention(params, one.dims, cfg.d_model)
    placed = par.place(params)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, prompt)).astype(np.int32)
    toks = torch.from_numpy(prompts).to(dev)
    cache = prompt + STATE_NEW
    label = f"tp2 {name} prefill"
    eng = repro_torch.ServeEngine(par, placed, max_seq_len=cache)
    eng.generate(prompts, 1)
    counter.reset()
    t0 = time.perf_counter()
    first, runs[label] = counted(lambda: eng.generate(prompts, 1))
    prefill_s = time.perf_counter() - t0
    c_pre = counter.snapshot()
    if runs[label]["K7"] != 2 * n_attn:
        raise AssertionError(f"{name} tp=2: the prefill launched K7 "
                             f"{runs[label]['K7']} times, not once per slot "
                             f"per attention layer ({2 * n_attn})")
    counter.reset()
    t0 = time.perf_counter()
    out, _ = counted(lambda: eng.generate(prompts, STATE_NEW))
    gen_s = time.perf_counter() - t0
    c_gen = counter.snapshot()
    peak = torch.cuda.max_memory_allocated()
    if (out.shape != (batch, STATE_NEW) or out.min() < 0
            or out.max() >= cfg.vocab_size
            or not np.array_equal(out[:, :1], first)):
        raise AssertionError(f"{name} tp=2: generated {out.shape} tokens "
                             f"in [{out.min()}, {out.max()}]")
    steps = STATE_NEW - 1
    c_dec = {k: {kind: c_gen[k][kind] - c_pre[k][kind]
                 for kind in c_gen[k]} for k in ("bytes", "calls")}
    with torch.inference_mode():
        lf = unshard(par.prefill(placed, toks, cache)[0])[:, -1].float()
        lo = one.prefill(params, toks, cache)[0][:, -1].float()
    bf16_err = float(((lf - lo).abs().amax(-1) / lo.abs().amax(-1)).max())
    del eng, placed, lf, lo
    torch.cuda.empty_cache()
    # float32 copies of the same weights: the split path's function
    # against one slot's, below bf16's rounding of the partial sums
    params = tree_map(lambda x: x.float(), params)
    got, got_toks = f32_decode(par, par.place(params), toks, cache,
                               STATE_NEW)
    want, want_toks = f32_decode(one, params, toks, cache, STATE_NEW)
    worst, compared = 0.0, [0] * batch
    live = [True] * batch
    for step, (g, w) in enumerate(zip(got, want)):
        if not (torch.isfinite(g).all() and torch.isfinite(w).all()):
            raise AssertionError(f"{name} tp=2 float32: logits not finite")
        scale = w.abs().amax(dim=-1)
        err = (g - w).abs().amax(dim=-1) / scale
        worst = max(worst, float(err.max()))
        if (err > STATE_F32_TOL).any():
            raise AssertionError(f"{name} tp=2 float32 step {step}: logits "
                                 f"differ by {err.tolist()} of the largest "
                                 f"(tolerance {STATE_F32_TOL})")
        top2 = w.topk(2, dim=-1).values
        gap = (top2[:, 0] - top2[:, 1]) / scale
        for i in range(batch):
            live[i] = live[i] and bool(gap[i] > STATE_F32_TOL)
            if live[i]:
                if got_toks[i, step] != want_toks[i, step]:
                    raise AssertionError(f"{name} tp=2 float32 stream {i}: "
                                         f"greedy tokens differ at step "
                                         f"{step}")
                compared[i] += 1
    lay = par.layout
    splits = [k for k in ("rec_split", "mlp_split", "mlstm_split",
                          "mlstm_cell_split", "slstm_split",
                          "slstm_state_split") if getattr(lay, k)]
    kinds = {k: cfg.layer_kinds().count(k)
             for k in dict.fromkeys(cfg.layer_kinds())}
    log(f"[state serve] {cfg.name} layers={cfg.n_layers} kinds={kinds} "
        f"tp=2 on mesh {mesh.shape}, flash; split={splits}; "
        f"prompts={batch}x{prompt} new_tokens={STATE_NEW} (bf16) "
        f"prefill_s={prefill_s:.4f} generate_s={gen_s:.3f} "
        f"decode_ms_per_step={(gen_s - prefill_s) / steps * 1e3:.2f} "
        f"max_memory_allocated={peak} launches={runs[label]} "
        f"K7_per_slot={runs[label]['K7'] // 2}; collectives a prefill: "
        f"{coll_line(c_pre)}; a decode step: "
        f"{coll_line(dict(c_dec, total=0), steps)}; float32 vs one slot, "
        f"prefill and {steps} decode steps: max_err_over_max_logit="
        f"{worst:.2e} (tolerance {STATE_F32_TOL}), greedy tokens equal "
        f"for compared_steps={compared} of {STATE_NEW}; bf16 vs one slot "
        f"(logged, the partial sums' bf16 rounding) "
        f"max_err_over_max_logit={bf16_err:.4f}")
    del params, got, want
    torch.cuda.empty_cache()


def moe_groups_serve(runs, dev) -> None:
    """qwen2-moe-a2.7b at full width, STATE_MOE_LAYERS of 24 layers, on
    (data, model) = (2, 2) slots: the two data groups in lockstep, one
    routing over the whole batch, each group's 30 experts a slot; the
    prefill against the unsharded build (one slot, tp = 2) under one
    routing (``RouteLog`` replays the one slot's top-k), the routing of
    its own logged."""
    import dataclasses

    import repro_torch
    from repro_torch.models import moe
    from repro_torch.models.params import init_params
    from repro_torch.sharding import counter, unshard
    cfg = dataclasses.replace(repro_torch.get_config(PAR_MOE_ARCH),
                              attn_impl="flash", n_layers=STATE_MOE_LAYERS)
    mesh = repro_torch.make_host_mesh(2, model=2)
    par = repro_torch.build_model(cfg, 2, mesh=mesh)
    one = repro_torch.build_model(cfg, 2)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(one.param_specs(),
                         torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    condition_attention(params, one.dims, cfg.d_model)
    placed = par.place(params)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (STATE_MOE_BATCH, LLM_PROMPT)).astype(np.int32)
    ).to(dev)

    def prefill(m, p):
        with torch.inference_mode():
            lg = m.prefill(p, toks, LLM_PROMPT)[0]
        return (unshard(lg) if m is par else lg)[:, -1].float()
    prefill(par, placed)
    counter.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, runs["moe 2x2 prefill"] = counted(lambda: prefill(par, placed))
    prefill_s = time.perf_counter() - t0
    c_pre = counter.snapshot()
    if runs["moe 2x2 prefill"]["K7"] != 4 * cfg.n_layers:
        raise AssertionError(f"the (2, 2) MoE prefill launched K7 "
                             f"{runs['moe 2x2 prefill']['K7']} times, not "
                             f"once per slot per layer ({4 * cfg.n_layers})")
    peak = torch.cuda.max_memory_allocated()
    route = moe.route
    try:
        moe.route = one_log = RouteLog(route)
        lo = prefill(one, params)
        moe.route = own_log = RouteLog(route)
        free = prefill(par, placed)
        moe.route = RouteLog(route, replay=one_log.calls)
        lf = prefill(par, placed)
    finally:
        moe.route = route
    if [c.shape for c in own_log.calls] != [c.shape for c in one_log.calls]:
        raise AssertionError("the (2, 2) prefill did not route the whole "
                             "batch once a layer")
    worst = logits_agree("MoE on (2, 2) vs one slot", lf, lo)
    log(f"[state moe] {cfg.name} layers={cfg.n_layers} of 24 on mesh "
        f"{mesh.shape}: groups in lockstep, experts {list(par.layout.experts)}"
        f" (first, count) a slot; prompts={STATE_MOE_BATCH}x{LLM_PROMPT} "
        f"prefill_s={prefill_s:.4f} max_memory_allocated={peak} launches="
        f"{runs['moe 2x2 prefill']} K7_per_slot="
        f"{runs['moe 2x2 prefill']['K7'] // 4}; collectives a prefill: "
        f"{coll_line(c_pre)}; vs one slot under one routing "
        f"max_err_over_max_logit={worst:.4f} (tolerance {LLM_LOGIT_TOL}); "
        f"own routing routed_alike="
        f"{routed_alike(one_log.calls, own_log.calls):.5f} "
        f"max_err_over_max_logit="
        f"{float(((free - lo).abs().amax(-1) / lo.abs().amax(-1)).max()):.4f}")
    del params, placed, lo, lf, free
    torch.cuda.empty_cache()


def moe_groups_train(runs, dev) -> None:
    """The ZeRO-1 train step of qwen2-moe (full width, STATE_MOE_TRAIN_
    LAYERS layers, plain attention, remat "dots") on (data, model) =
    (2, 2) slots, the groups in lockstep: STATE_MOE_TRAIN_STEPS steps on
    one batch of STATE_MOE_TRAIN_SEQS x 2 048 tokens as 2 microbatches of
    the whole batch, against the single-slot step (tp = 2, 2
    microbatches) on the same batch and weights, by the PAR_* bounds."""
    import dataclasses

    import repro_torch
    from repro_torch.models.params import tree_leaves
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.parallel import place_train_state
    cfg = dataclasses.replace(repro_torch.get_config(PAR_MOE_ARCH),
                              attn_impl="jnp", remat="dots",
                              n_layers=STATE_MOE_TRAIN_LAYERS)
    opt = repro_torch.AdamWConfig(lr=TRAIN_LR, warmup_steps=1)
    batch = repro_torch.TokenStream(cfg.vocab_size, STATE_MOE_TRAIN_SEQS,
                                    LLM_PROMPT, seed=0,
                                    device=dev).batch_at(0)
    one = repro_torch.build_model(cfg, 2)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    p = par_train_weights(one, cfg, dev)
    n_params = sum(x.numel() for x in tree_leaves(p))
    state = {"params": p, "opt": adamw_init(p)}
    del p
    (state, ref), _ = counted(lambda: par_train_run(
        repro_torch.make_train_step(one, opt, microbatches=2), state, batch,
        STATE_MOE_TRAIN_STEPS))
    ref_peak = torch.cuda.max_memory_allocated()
    master = [x.cpu() for x in tree_leaves(state["opt"]["master"])]
    del state
    torch.cuda.empty_cache()
    mesh = repro_torch.make_host_mesh(2, model=2)
    par = repro_torch.build_model(cfg, 2, mesh=mesh)
    torch.cuda.reset_peak_memory_stats()
    state = place_train_state(par, params=par.place(par_train_weights(
        par, cfg, dev)))
    step = repro_torch.make_train_step(par, opt, microbatches=2)
    (state, got), runs["moe 2x2 train"] = counted(lambda: par_train_run(
        step, state, batch, STATE_MOE_TRAIN_STEPS))
    peak = torch.cuda.max_memory_allocated()
    r = par_train_readings(state, got, ref, master)
    for i, (a, b) in enumerate(zip(got, ref)):
        log(f"[state moe train] step {i + 1}: loss={a['loss']:.5f} (one "
            f"slot {b['loss']:.5f}) grad_norm={a['grad_norm']:.4f} (one "
            f"slot {b['grad_norm']:.4f}) s={a['s']:.3f} (one slot "
            f"{b['s']:.3f}) collectives: {coll_line(a['coll'])}")
    bad = par_train_faults(r)
    if bad:
        raise AssertionError("MoE training on (2, 2) vs one slot: "
                             + "; ".join(bad))
    if runs["moe 2x2 train"]["K7"] != 0:
        raise AssertionError("training launched K7")
    log(f"[state moe train] {cfg.name} layers={cfg.n_layers} of 24 "
        f"params={n_params} on mesh {mesh.shape}: ZeRO-1, groups in "
        f"lockstep, remat={cfg.remat}, batch={STATE_MOE_TRAIN_SEQS}x"
        f"{LLM_PROMPT} as 2 microbatches of the whole batch; last_step_s="
        f"{got[-1]['s']:.3f} max_memory_allocated={peak} (one slot: "
        f"last_step_s={ref[-1]['s']:.3f} max_memory_allocated={ref_peak});"
        f" {par_train_line(r)}")
    del state, master, batch, step
    torch.cuda.empty_cache()


def dry_run_line(smi) -> None:
    """One cell of the dry run (``launch/dryrun.py``) on the 16 x 16
    ``meta`` mesh: its per-card roofline terms on the H100's peaks,
    beside the card they stand for."""
    from repro_torch.launch.dryrun import lower_cell
    arch, shape = DRY_RUN_CELL
    t0 = time.perf_counter()
    res = lower_cell(arch, shape)
    r, m = res["roofline"], res["memory"]
    log(f"[dry run] {arch} {shape} on {res['mesh']} meta slots "
        f"({res['slots_counted']} counted) for {smi}: compute_s="
        f"{r['compute_s']:.4e} memory_s={r['memory_s']:.4e} collective_s="
        f"{r['collective_s']:.4e} dominant={r['dominant']} "
        f"roofline_fraction={r['roofline_fraction']:.4f} flops="
        f"{r['flops']:.4e} bytes={r['bytes_accessed']:.4e} "
        f"collective_bytes={r['collective_bytes']:.4e} argument_bytes="
        f"{m['argument_bytes']} peak_hbm_estimate={m['peak_hbm_estimate']} "
        f"wall_s={time.perf_counter() - t0:.3f}")


def state_moe_phase(runs, dev, smi) -> None:
    """Phase 6e: the state-axis layers over model slots, an MoE model
    routed whole across data groups, and one dry-run cell; every slot on
    the one card."""
    t0 = time.perf_counter()
    jobs = [(f"state_serve {name}", functools.partial(state_serve, name, b,
                                                      length))
            for name, b, length in STATE_RUNS]
    jobs += [("moe_groups_serve", moe_groups_serve),
             ("moe_groups_train", moe_groups_train),
             ("dry_run_line", lambda runs, dev: dry_run_line(smi))]
    parts = {}
    for key, fn in jobs:
        t = time.perf_counter()
        fn(runs, dev)
        parts[key] = round(time.perf_counter() - t, 3)
    log(f"[state] phase_s={time.perf_counter() - t0:.3f} parts_s="
        f"{json.dumps(parts)}")


def k7_pairs(l, window):
    """(q, k) pairs K7's masks keep in one head: sum over q < l of
    min(q + 1, window)."""
    w = l if window is None else min(window, l)
    return w * (w + 1) // 2 + (l - w) * w


def k7_check(label, b, l, h, kv, d, window, dtype, dev):
    """K7 against its plain version on seeded normal q, k, v -> a dict of
    its numbers: error, times, bound, and SDPA's time (causal, or with
    the window's band as a boolean mask; not for float32 windows). ``kv`` None: the merged (B*H, L, D) layout through
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
    if window is None:
        out["library_ms"] = cuda_ms(lambda: sdpa(
            q4, k4, v4, is_causal=True, enable_gqa=gqa), 20)
    elif dtype == torch.bfloat16:
        # SDPA takes no window: the causal band as a boolean mask
        pos = torch.arange(l, device=dev)
        band = ((pos[None, :] <= pos[:, None])
                & (pos[None, :] > pos[:, None] - window))
        out["library_ms"] = cuda_ms(lambda: sdpa(
            q4, k4, v4, attn_mask=band, enable_gqa=gqa), 20)
        del band
    else:
        out["library_ms"] = None
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
    phase. With ``emit="mask"`` the ``kernel_*`` methods run K3/K5, the
    dense path ``popcount``/``onehot`` take at every threshold, so they
    take it at ``FRONT_DOOR_T`` only (the front door's calls)."""
    return [(name, method, m, t, e) for name, methods in MEASURE_SETS
            for method in methods for m in MEASURES for t in THRESHOLDS
            for e in ("pairs", "mask")
            if e == "pairs" or not method.startswith("kernel_")
            or t == FRONT_DOOR_T]


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
    for k, cfg in enumerate(configs):
        out.append(port_join(*data[cfg[0]], *cfg[1:]))
        if k + 1 == len(configs) or configs[k + 1][:2] != cfg[:2]:
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
            n = sum(c[:2] == (name, method) for c in configs)
            log(f"[measures] {name} {method} |R|=|S|={sizes[name]} "
                f"configs={n} cuda==cpu pairs={n_pairs}")


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


def baseline_slice(R, S):
    """The first BASELINE_ROWS sets of each side (ids kept)."""
    from repro_torch.core.sets import SetCollection
    return tuple(SetCollection(C.sets[:BASELINE_ROWS], C.universe,
                               C.ids[:BASELINE_ROWS]) for C in (R, S))


def cpu_baseline(name):
    """Pool worker: one host baseline on the kosarak slice -> (its pairs
    as sorted int64 keys' digest, its stats, the seconds it took)."""
    from repro_torch.core import baselines
    R, S = baseline_slice(*_WORKER_DATA[BASELINE_SET])
    args = (MR_MEASURE_SHARDS,) if name in ("mr_rp_ppjoin", "fs_join") else ()
    st: dict = {}
    t0 = time.perf_counter()
    pairs = getattr(baselines, name)(R, S, BASELINE_T, *args, stats=st)
    pr = np.asarray(sorted(pairs), np.int64).reshape(-1, 2)
    return pair_digest(pr[:, 0], pr[:, 1]), st, time.perf_counter() - t0


def baselines_compare(base_async) -> None:
    """Each baseline's pairs (from the CPU workers) against the card's
    ``lfvt`` join of the same slice."""
    import repro_torch
    R, S = baseline_slice(*measures_data(BASELINE_SET))
    t0 = time.perf_counter()
    res = repro_torch.join(R, S, BASELINE_T, method="lfvt")
    pr = np.asarray(sorted(res.pairs), np.int64).reshape(-1, 2)
    want = pair_digest(pr[:, 0], pr[:, 1])
    card_s = time.perf_counter() - t0
    for name, (digest, st, sec) in zip(BASELINES, base_async.get(),
                                       strict=True):
        if digest != want:
            raise AssertionError(f"baseline {name}: {digest[0]} pairs, the "
                                 f"card's lfvt join {want[0]}")
        log(f"[baselines] {name} {BASELINE_SET} {BASELINE_ROWS}x"
            f"{BASELINE_ROWS} t={BASELINE_T} pairs={digest[0]} (== card "
            f"lfvt join) stats={json.dumps(st)} worker_s={sec:.3f}")
    log(f"[baselines] card lfvt join of the slice s={card_s:.3f}")


def mesh_measures(cfgs, loop_out) -> None:
    """The measures phase's mesh calls on the card (MESH_MEASURE_CALLS at
    MR_MEASURE_SHARDS slots on one card): each must equal the card's
    loop-path MR call (``mr_configs``) in pairs and in the stats the two
    share, and launch its kernel: K6 under ``"planned"``, K1 under
    ``"static"``, K3 for ``popcount``, K5 for ``kernel_onehot``."""
    import repro_torch
    mesh = repro_torch.make_host_mesh(MR_MEASURE_SHARDS)
    loop = {c[:5]: out for c, out in zip(cfgs, loop_out)
            if c[5] == "load_aware" and c[6] is None}
    kernel = {("lfvt", "planned"): "K6", ("lfvt", "static"): "K1",
              ("popcount", None): "K3", ("kernel_onehot", None): "K5"}
    t0 = time.perf_counter()
    for name, method, measure, schedule, emit in MESH_MEASURE_CALLS:
        cfg = (name, method, measure, MR_T[measure], emit, "load_aware", None)
        kw = {"schedule": schedule} if schedule else {}
        (digest, st), launches = counted(lambda: mr_join(
            *measures_data(name), cfg, mesh=mesh, **kw))
        want_digest, want = loop[cfg[:5]]
        shared = MESH_SHARED[schedule] + (
            ("reduce_bytes",) if method == "lfvt" and emit == "mask" else ())
        kid = kernel[method, schedule]
        if (digest != want_digest
                or any(st[k] != want[k] for k in shared)
                or launches[kid] < 1
                or (schedule == "static"
                    and st["live_tiles"] != st["total_tiles"])):
            raise AssertionError(f"mesh {cfg} schedule={schedule}: "
                                 f"{digest} {st} {launches} vs the loop "
                                 f"path's {want_digest} {want}")
        log(f"[measures mesh] {name} {method} {measure} emit={emit} "
            f"schedule={schedule} slots={MR_MEASURE_SHARDS} pairs="
            f"{digest[0]} (== loop path) shared="
            f"{json.dumps({k: st[k] for k in shared})} live_tiles="
            f"{st['live_tiles']}/{st['total_tiles']} {kid}={launches[kid]}")
    log(f"[measures mesh] calls={len(MESH_MEASURE_CALLS)} "
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


def mr_phase(R, Ss, want, runs) -> dict:
    """The MapReduce driver at full size: ``repro_torch.join(R, S, 0.8,
    n_shards=8)`` with ``lfvt`` (cold, then warm and profiled), ``auto`` and
    ``kernel_bitmap``; each must give ``want`` (the single-device join's
    pairs) and launch its kernels as counted -> the ``lfvt`` call's
    stats."""
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
            f"walk_steps={st.get('walk_steps')} early_stops="
            f"{st.get('early_stops')} regrows={st['regrows']} "
            f"shard_methods={st.get('shard_methods')} max_memory_allocated="
            f"{torch.cuda.max_memory_allocated()} launches={launches}")
        runs[f"mr_{label}"] = launches
        return launches, st

    got, lfvt_stats = call("lfvt", method="lfvt")
    if got["K1"] != live:
        raise AssertionError(f"MR lfvt launched K1 {got['K1']} times, "
                             f"{live} shards have live rows")
    # warm: its wall is the profile's
    log_profile("warm mr lfvt join", device_profile(
        lambda: repro_torch.join(R, Ss, MAIN_T, n_shards=MR_SHARDS,
                                 method="lfvt"),
        ("lfvt_walk_kernel",)), "K1")
    got, _ = call("auto")
    if got["K1"] + got["K3"] < 1:
        raise AssertionError(f"MR auto launched no kernel: {got}")
    got, _ = call("kernel_bitmap", method="kernel_bitmap")
    if not live <= got["K2"] <= MR_SHARDS:
        raise AssertionError(f"MR kernel_bitmap launched K2 {got['K2']} "
                             f"times for {live} live shards")
    log_profile("warm mr kernel_bitmap join", device_profile(
        lambda: repro_torch.join(R, Ss, MAIN_T, n_shards=MR_SHARDS,
                                 method="kernel_bitmap"),
        ("bitmap_join_kernel", "bitmap_union_kernel")), "K2")
    return lfvt_stats


def mesh_shard_check(R, Ss, s_rows, r_rows, want, dev) -> str:
    """One livej shard's mesh body (``_lfvt_local_mask``) on the card,
    under ``"planned"`` (K6) and ``"static"`` (K1), against its plain
    version (the same call on the CPU, where the walk's plain PyTorch
    version runs): mask, walk steps, early stops and live tiles bit-equal.
    The rows are MESH_SLICE_TILES row tiles of the shard that finds the
    first pair, around its R row, in the shard's size order; the table
    is padded as a bucket with a larger sibling pads it (entries and
    sequence to the next power of two, MESH_SLICE_PAD_COLS size-0 S
    columns, one dead row tile) -> the check's text for the kernels
    line."""
    from repro_torch import global_config
    from repro_torch.core import distributed as dist
    from repro_torch.core.device import upload
    from repro_torch.core.sets import SetCollection
    t0 = time.perf_counter()
    tm = global_config.row_tile  # as the mesh join tiles its rows
    r_id, s_id = min(want)
    row = int(np.nonzero(R.ids == r_id)[0][0])
    k = next(k for k in range(len(r_rows))
             if np.isin(row, r_rows[k]) and np.isin(s_id, Ss.ids[s_rows[k]]))
    rs = r_rows[k][np.argsort(-R.sizes()[r_rows[k]], kind="stable")]
    first = max(0, (int(np.nonzero(rs == row)[0][0]) // tm
                    - MESH_SLICE_TILES // 2) * tm)
    rs = rs[first:first + MESH_SLICE_TILES * tm]
    ss = s_rows[k]
    flat = SetCollection([Ss.sets[int(j)] for j in ss], Ss.universe,
                         Ss.ids[ss].astype(np.int32)).flat_lfvt()
    lr = max(int(R.sizes()[rs].max()), 1)
    caps = ((-(-len(rs) // tm) + 1) * tm, flat.n_sets + MESH_SLICE_PAD_COLS,
            1 << (len(flat.entry_elem) - 1).bit_length(),
            1 << (len(flat.seq_row) - 1).bit_length(), flat.max_seq_len)
    arrays, r_ids, s_ids, _, _ = dist._lfvt_bucket_arrays(
        [(k, flat, rs, lr)], caps, lr, R.padded()[0], R.sizes(), R.ids,
        MAIN_T, "jaccard")
    kw = dict(t=MAIN_T, measure="jaccard", max_steps=caps[4], tm=tm)
    found, plain_s = None, 0.0
    for schedule in ("planned", "static"):
        t1 = time.perf_counter()
        want_out = dist._lfvt_local_mask(
            *(torch.from_numpy(a[0]) for a in arrays), schedule=schedule,
            **kw)
        plain_s += time.perf_counter() - t1
        got = dist._lfvt_local_mask(*(upload(a[0], dev) for a in arrays),
                                    schedule=schedule, **kw)
        for name, g, w in zip(("mask", "walk_steps", "early_stops",
                               "live_tiles"), got, want_out):
            if not torch.equal(g.cpu(), w):
                raise AssertionError(
                    f"mesh shard {k} ({schedule}): {name} on the card "
                    f"differs from its plain version")
        rr, cc = np.nonzero(want_out[0].numpy())
        found = {(int(r_ids[0, i]), int(s_ids[0, j])) for i, j in zip(rr, cc)}
        steps = [int(x) for x in want_out[1:]]
        log(f"[mesh shard] shard={k} {schedule}: rows={len(rs)} "
            f"mp={caps[0]} n={flat.n_sets} np={caps[1]} "
            f"E={len(flat.entry_elem)}->{caps[2]} "
            f"T={len(flat.seq_row)}->{caps[3]} max_steps={caps[4]} "
            f"walk_steps, early_stops, live_tiles={steps} pairs={len(found)}")
    if (r_id, s_id) not in found or not found <= want:
        raise AssertionError(f"mesh shard {k}: the slice's pairs {found} "
                             f"miss ({r_id}, {s_id}) or leave the join's")
    log(f"[mesh shard] card == plain (CPU) under both schedules: "
        f"plain_s={plain_s:.3f} s={time.perf_counter() - t0:.3f}")
    return (f"bit-equal to its plain version on {MESH_SLICE_TILES} row "
            f"tiles of a livej mesh shard (bucket-padded tables)")


def mesh_phase(R, Ss, want, runs, loop, dev) -> str:
    """The multi-device path at full size: ``repro_torch.join(R, S, 0.8,
    mesh=make_host_mesh(8))`` (8 slots on the one card) with ``lfvt``
    under ``"planned"`` (K6 once per shard with rows on both sides;
    then profiled) and ``"static"`` (K1 as often), then the stacked
    ``popcount`` reduce with ``emit="pairs"`` (K3 per shard); each must
    give ``want``, the single-device join's pairs. The lfvt calls must
    equal ``loop`` (the loop path's ``lfvt`` stats) in walk steps and
    early stops, and under ``"planned"`` in live tiles; then one shard's
    body against its plain version (``mesh_shard_check``) -> that
    check's text."""
    import repro_torch
    from repro_torch.core.distributed import shard_blocks
    from repro_torch.core.partition import load_aware_partition, route
    mesh = repro_torch.make_host_mesh(MR_SHARDS)
    part = load_aware_partition(R, Ss, MAIN_T, MR_SHARDS)
    s_rows, r_rows, _ = route(R, Ss, part)
    walked = sum(1 for rs, ss in zip(r_rows, s_rows) if len(rs) and len(ss))
    live = mr_live_shards(R, Ss, MAIN_T)
    log(f"[mesh] slots={len(mesh.devices)} devices="
        f"{sorted({str(d) for d in mesh.devices})} shards_with_rows="
        f"{walked} shards_with_live_rows={live}")

    def call(label, profiled=(), **kw):
        """One counted mesh join; under ``torch.profiler`` too when
        ``profiled`` names the kernels whose share to log."""
        st: dict = {}
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()

        def run():
            return repro_torch.join(R, Ss, MAIN_T, mesh=mesh, stats=st, **kw)

        if profiled:
            got = {}
            prof, launches = counted(lambda: device_profile(
                lambda: got.setdefault("out", run()), profiled))
            out = got["out"]
        else:
            out, launches = counted(run)
        wall = time.perf_counter() - t0
        if out.pairs != want:
            raise AssertionError(f"mesh {label}: {len(out.pairs)} pairs, "
                                 f"the single-device join {len(want)}")
        if profiled:
            log_profile(f"warm mesh {label} join", prof, "K6")
        log(f"[mesh {label}] pairs={len(out.pairs)} (== single-device) "
            f"wall_s={wall:.3f} n_buckets={st['n_buckets']} pad="
            f"{st['pad']} pad_waste_mean={st['pad_waste_mean']} "
            f"pad_waste_max={st['pad_waste_max']} flat_pad_waste="
            f"{st.get('flat_pad_waste')} live_tiles={st.get('live_tiles')}/"
            f"{st.get('total_tiles')} walk_steps={st.get('walk_steps')} "
            f"early_stops={st.get('early_stops')} walk_schedule="
            f"{st.get('walk_schedule')} mesh_devices="
            f"{st.get('mesh_devices')} shard_block_bytes="
            f"{st['shard_block_bytes']} dense_mask_bytes="
            f"{st['dense_mask_bytes']} reduce_bytes={st['reduce_bytes']} "
            f"regrows={st['regrows']} max_memory_allocated="
            f"{torch.cuda.max_memory_allocated()} launches={launches}")
        runs[f"mesh_{label}"] = launches
        return launches, st

    def same_walk(label, st, keys):
        """The mesh walk's counters against the loop path's: the same
        lanes walk the same live tiles."""
        diff = {k: (st[k], loop[k]) for k in keys if st[k] != loop[k]}
        if diff:
            raise AssertionError(f"mesh {label} (mesh, loop path): {diff}")

    # counted and profiled in one run (the kernels are built and loaded;
    # nothing else is cached across calls)
    got, st = call("lfvt", ("lfvt_walk_planned_kernel",), method="lfvt",
                   schedule="planned")
    if got["K6"] != walked or got["K1"]:
        raise AssertionError(f"mesh lfvt (planned) launched K6 {got['K6']} "
                             f"and K1 {got['K1']} times for {walked} "
                             "shards with rows")
    same_walk("lfvt", st, ("walk_steps", "early_stops", "live_tiles"))
    got, st = call("lfvt_static", method="lfvt", schedule="static")
    if got["K1"] != walked or got["K6"]:
        raise AssertionError(f"mesh lfvt (static) launched K1 {got['K1']} "
                             f"and K6 {got['K6']} times for {walked} "
                             "shards with rows")
    # "static" also walks the tiles the loop path's host plan skips; with
    # every real tile live (livej at t = 0.8) the counters are the same
    if loop["live_tiles"] == loop["total_tiles"]:
        same_walk("lfvt_static", st, ("walk_steps", "early_stops"))
    elif st["walk_steps"] < loop["walk_steps"]:
        raise AssertionError(f"mesh lfvt (static) walked {st['walk_steps']} "
                             f"steps, the loop path {loop['walk_steps']}")
    # the stacked reduce packs one globally padded block on the host
    t0 = time.perf_counter()
    blocks, _ = shard_blocks(R, Ss, part, MAIN_T, pad="global")
    log(f"[mesh popcount] host shard_blocks(pad='global') s="
        f"{time.perf_counter() - t0:.3f} block_bytes="
        f"{blocks[0].block_bytes()} m_pad={blocks[0].m_pad} "
        f"n_pad={blocks[0].n_pad}")
    del blocks
    got, _ = call("popcount", method="popcount")
    if not live <= got["K3"] <= MR_SHARDS:
        raise AssertionError(f"mesh popcount launched K3 {got['K3']} times "
                             f"for {live} live shards")
    return mesh_shard_check(R, Ss, s_rows, r_rows, want, dev)


def child_result(proc, label: str) -> dict:
    """Wait for an ``mr_child`` that must run to its end -> its JSON."""
    out, err = child_output(proc)
    if proc.returncode != 0:
        raise AssertionError(f"the {label} MR child exited "
                             f"{proc.returncode}: {err[-2000:]}")
    return json.loads(out.strip().splitlines()[-1])


def managed_phase(R, Ss, want, runs, device_stats, loop, dev) -> None:
    """The fault-tolerant drivers (``checkpoint_dir=``) at livej scale,
    the guardrail's budget resolved from the card: the single-device
    ``lfvt`` call (K1 as often as the unmanaged call, ``device_stats``,
    whose walk counters it must equal), the MR loop call (K1 once per
    shard with a live row; pairs, walk counters and bytes equal to
    ``loop``, the unmanaged call's stats) and the mesh call under
    ``"planned"`` (K6 once per shard with rows, no guardrail
    degradation, walk counters equal to ``loop``), each with no split,
    no degradation and ``want``'s pairs; then the loop call again with
    the budget pinned to cut every shard into MANAGED_SPLIT_SPANS spans
    (each shard's S encoded once, ``want``'s pairs). Meanwhile a child
    process runs the loop call, killed at its 2nd checkpoint write, and
    a second child resumes it: ``want``'s pairs, a task resumed."""
    import shutil
    import repro_torch
    from repro_torch import global_config
    from repro_torch.core import lfvt_flat
    from repro_torch.core.config import resolve_guardrail_budget
    from repro_torch.core.partition import load_aware_partition, route
    base = ROOT / "build" / MANAGED_DIR
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    t0 = time.perf_counter()
    data = base / "livej.npz"
    save_sets(data, r=R, s=Ss)
    kill_dir = base / "kill"
    children = {"kill": mr_child_proc("kill", kill_dir, data)}
    try:
        log(f"[managed] livej sets saved for the kill-and-resume children: "
            f"bytes={data.stat().st_size} s={time.perf_counter() - t0:.3f}; "
            f"guardrail budget={resolve_guardrail_budget(dev)} B (total"
            f"_memory={torch.cuda.get_device_properties(dev).total_memory} "
            f"B, guardrail_budget={global_config.guardrail_budget})")
        part = load_aware_partition(R, Ss, MAIN_T, MR_SHARDS)
        s_rows, r_rows, _ = route(R, Ss, part)
        walked = [k for k in range(MR_SHARDS)
                  if len(r_rows[k]) and len(s_rows[k])]
        live = mr_live_shards(R, Ss, MAIN_T)
        want_digest = pair_digest(*np.array(sorted(want), np.int64)
                                  .reshape(-1, 2).T)

        def call(label, **kw):
            st: dict = {}
            ckpt = base / label
            torch.cuda.reset_peak_memory_stats()
            t1 = time.perf_counter()
            out, launches = counted(lambda: repro_torch.join(
                R, Ss, MAIN_T, stats=st, checkpoint_dir=str(ckpt), **kw))
            wall = time.perf_counter() - t1
            tasks = len(list(ckpt.glob("task_*.npz")))
            if out.pairs != want:
                raise AssertionError(f"managed {label}: {len(out.pairs)} "
                                     f"pairs, the single-device join "
                                     f"{len(want)}")
            log(f"[managed {label}] pairs={len(out.pairs)} (== single-"
                f"device) wall_s={wall:.3f} max_memory_allocated="
                f"{torch.cuda.max_memory_allocated()} guardrail_splits="
                f"{st['guardrail_splits']} degradations="
                f"{json.dumps(st['degradations'])} retries={st['retries']} "
                f"tasks={tasks} tasks_resumed={st['tasks_resumed']} "
                f"live_tiles={st.get('live_tiles')}/"
                f"{st.get('total_tiles')} walk_steps={st.get('walk_steps')} "
                f"early_stops="
                f"{st.get('early_stops')} launches={launches}")
            runs[f"managed_{label}"] = launches
            return launches, st, tasks

        def same(label, st, want_st, keys):
            diff = {k: (st[k], want_st[k]) for k in keys
                    if st[k] != want_st[k]}
            if diff:
                raise AssertionError(f"managed {label} (managed, "
                                     f"unmanaged): {diff}")

        def clean(label, st):
            if (st["guardrail_splits"] or st["degradations"]
                    or st["retries"]):
                raise AssertionError(f"managed {label}: splits "
                                     f"{st['guardrail_splits']}, "
                                     f"degradations {st['degradations']}, "
                                     f"retries {st['retries']}")

        got, st, tasks = call("device", method="lfvt")
        clean("device", st)
        blocks = device_stats["r_blocks"]
        if got["K1"] != runs["lfvt"]["K1"] or tasks != blocks:
            raise AssertionError(f"managed device: K1 {got['K1']} times, "
                                 f"{tasks} tasks; the unmanaged call "
                                 f"{runs['lfvt']['K1']}, {blocks} blocks")
        same("device", st, device_stats, ("walk_steps", "early_stops",
                                          "live_tiles", "total_tiles"))
        got, st, tasks = call("loop", n_shards=MR_SHARDS, method="lfvt")
        clean("loop", st)
        if got["K1"] != live or tasks != len(walked):
            raise AssertionError(f"managed loop: K1 {got['K1']} times, "
                                 f"{tasks} tasks; {live} live shards, "
                                 f"{len(walked)} with rows")
        same("loop", st, loop, ("result_pairs", "walk_steps", "early_stops",
                                "live_tiles", "total_tiles",
                                "shard_block_bytes", "reduce_bytes"))

        killed = children["kill"]
        _, err = child_output(killed)
        if killed.returncode != -signal.SIGKILL:
            raise AssertionError(f"the killed MR child exited "
                                 f"{killed.returncode}: {err[-2000:]}")
        saved = len(list(kill_dir.glob("task_*.npz")))
        children["resume"] = mr_child_proc("resume", kill_dir, data)

        got, st, tasks = call(
            "mesh", mesh=repro_torch.make_host_mesh(MR_SHARDS),
            method="lfvt", schedule="planned")
        clean("mesh", st)
        if got["K6"] != len(walked) or got["K1"]:
            raise AssertionError(f"managed mesh launched K6 {got['K6']} and "
                                 f"K1 {got['K1']} times for {len(walked)} "
                                 "shards with rows")
        same("mesh", st, loop, ("walk_steps", "early_stops", "live_tiles"))

        # the loop call with every shard cut into spans: each shard's S is
        # encoded once, not once a span
        est = {k: len(r_rows[k]) * len(s_rows[k]) * 4 for k in walked}
        least, most = MANAGED_SPLIT_SPANS
        forced = -(-max(est.values()) // most)
        spans = {k: min(len(r_rows[k]), -(-e // forced))
                 for k, e in est.items()}
        if not all(least <= n <= most for n in spans.values()):
            raise AssertionError(f"a budget of {forced} B cuts the shards "
                                 f"into {spans} spans, not {least}-{most}")
        encodes, encode = [], lfvt_flat.encode
        pinned = global_config.guardrail_budget

        def counting(*args, **kw):
            encodes.append(1)
            return encode(*args, **kw)

        lfvt_flat.encode, global_config.guardrail_budget = counting, forced
        try:
            got, st, tasks = call("split", n_shards=MR_SHARDS, method="lfvt")
        finally:
            lfvt_flat.encode, global_config.guardrail_budget = encode, pinned
        if (st["guardrail_splits"] != sum(spans.values()) - len(spans)
                or tasks != sum(spans.values()) or st["degradations"]
                or len(encodes) != len(walked) or got["K1"] < live):
            raise AssertionError(f"managed split at {forced} B: splits "
                                 f"{st['guardrail_splits']}, tasks {tasks}, "
                                 f"encodes {len(encodes)}, K1 {got['K1']}; "
                                 f"spans {spans}")
        log(f"[managed split] budget={forced} B spans_per_shard="
            f"{json.dumps(spans)} encodes={len(encodes)} (one per shard with "
            f"rows, {len(walked)})")

        resumed = child_result(children["resume"], "resumed")
        if (tuple(resumed["digest"]) != tuple(want_digest)
                or resumed["tasks_resumed"] < 1):
            raise AssertionError(f"kill and resume: {resumed} vs "
                                 f"{want_digest}")
        log(f"[managed kill] livej MR loop call killed at its 2nd "
            f"checkpoint write with {saved} task(s) saved, resumed "
            f"{resumed['tasks_resumed']}, guardrail_splits="
            f"{resumed['guardrail_splits']}, pairs={resumed['digest'][0]} "
            f"(== single-device) resume_wall_s={resumed['wall_s']:.3f}")
    finally:
        for proc in children.values():   # none outlives the phase
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def main() -> int:
    if sys.argv[1:2] == ["--mr-child"]:
        return mr_child(*sys.argv[2:5])
    if sys.argv[1:2] == ["--train-child"]:
        return train_child(*sys.argv[2:4])
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this script needs "
              "one GPU", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch import global_config
    from repro_torch.core.planner import (BENCH_GLOB, DEFAULT_COEFFS,
                                          effective_coeffs)
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
        base_async = pool.map_async(cpu_baseline, BASELINES, chunksize=1)
        ops_async = pool.map_async(cpu_ops_call, OPS_CALLS, chunksize=1)

        # ---- phase 2: the measures phase ----------------------------- #
        cuda_out, fronts, sizes = measures_cuda(configs)
        mr_out = mr_measures_cuda(mr_cfgs)
        mesh_measures(mr_cfgs, mr_out)
        # phase 6b's untimed half runs on the card while the CPU workers
        # finish: the training checks and the kill-and-resume children
        train_side_checks(dev)
        measures_compare(configs, cuda_out, fronts, sizes, cpu_async)
        mr_measures_compare(mr_cfgs, mr_out, mr_async)
        baselines_compare(base_async)
        ops_compare(ops_async)
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

    eff = effective_coeffs()
    log(f"[planner] calibration from {BENCH_GLOB} "
        f"(planner_calibrate={global_config.planner_calibrate}): scales " +
        json.dumps({fam: eff[fam]["fixed"] / c["fixed"]
                    for fam, c in DEFAULT_COEFFS.items()}))
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
    loop_stats = mr_phase(R, Ss, res.pairs, runs)
    log(f"[mr] phase_s={time.perf_counter() - t0:.3f}")
    t0 = time.perf_counter()
    mesh_note = mesh_phase(R, Ss, res.pairs, runs, loop_stats, dev)
    log(f"[mesh] phase_s={time.perf_counter() - t0:.3f}")
    t0 = time.perf_counter()
    managed_phase(R, Ss, res.pairs, runs, st, loop_stats, dev)
    log(f"[managed] phase_s={time.perf_counter() - t0:.3f}")

    # ---- phase 5: the dedup service on the livej corpus -------------- #
    t0 = time.perf_counter()
    k6 = serve_phase(R, Ss, runs, dev)
    k6["registers"] = walk_regs
    k6["check"] += "; " + mesh_note
    log(f"[serve] phase_s={time.perf_counter() - t0:.3f}")

    # ---- phase 6: LLM serving (qwen2-1.5b, K7) ------------------------ #
    t0 = time.perf_counter()
    llm_phase(runs, dev)
    log(f"[llm] phase_s={time.perf_counter() - t0:.3f}")

    # ---- phase 6b: training (qwen2-1.5b, full width) ------------------ #
    t0 = time.perf_counter()
    train_phase(runs, dev)
    log(f"[train] phase_s={time.perf_counter() - t0:.3f}")

    # ---- phase 6c: the other model families (K7 at D = 64, 128, 256) -- #
    families_phase(runs, dev)

    # ---- phase 6d: tensor, expert and data parallelism over the mesh -- #
    parallel_phase(runs, dev)

    # ---- phase 6e: state-axis layers over model slots, MoE across data
    # groups, one dry-run cell ------------------------------------------ #
    state_moe_phase(runs, dev, smi)
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
              f"t={MAIN_T} and t={WIDE_T}; {mesh_note}"), "K6": k6}

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
    d256 = k7[[case[0] for case in K7_CASES].index(K7_D256)]
    kernels["K7"] = dict(
        d256={key: d256[key] for key in ("label", "ms", "plain_ms",
                                          "bound_ms", "bound_by",
                                          "library_ms", "max_abs_err")},
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
                    "main_run": MAIN_RUN[kid],
                    # the other paths that launched it, counted alike
                    "other_runs": {label: n[kid] for label, n in runs.items()
                                   if label != MAIN_RUN[kid] and n[kid]},
                    **kernels[kid]})
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
