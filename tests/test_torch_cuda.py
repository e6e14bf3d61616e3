"""The port's CUDA kernels K1-K7 against their plain PyTorch versions.

Marked ``cuda``: every test skips (with a reason) where torch sees no
CUDA device. The file imports neither jax nor the JAX package, so it runs
on a machine that has only the port's dependencies::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Inputs are made from a seed with numpy; masks, counts, walk_steps and
early_stops must be bit-equal (integers and booleans, tolerance 0), and
so must every method's join, and the dedup service's results, on the
card and on the CPU. K7's outputs must be within the reference's float
tolerances of its plain version, and the LLM serving engine on the card
within a stated bfloat16 logit tolerance of the CPU's (``LOGIT_TOL``).
"""
import functools

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core.sets import SetCollection
from repro_torch.core.tile_join import window_bounds
from repro_torch.kernels import bitmap_join, lfvt_walk, onehot_join, ops
from repro_torch.kernels import flash_attention as fa

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def skewed(seed, n, universe, max_size):
    rng = np.random.default_rng(seed)
    return SetCollection.from_ragged(
        [rng.integers(0, universe, size=int(min(max_size, rng.zipf(1.4))))
         for _ in range(n)], universe=universe)


def walk_inputs(device, seed, t, measure, n_r=300, n_s=500, tm=16):
    R = skewed(seed, n_r, 200, 48)
    flat = skewed(seed + 1, n_s, 200, 48).sort_by_size().flat_lfvt()
    r_pad = torch.tensor(R.padded()[0], device=device)
    r_sz = R.sizes()
    lo, hi = window_bounds(r_sz, flat.s_sizes, t, measure)
    ti, operands, _ = ops.walk_operands(flat, r_pad, r_sz, lo, hi, tm)
    kw = dict(t=t, measure=measure, max_steps=int(flat.max_seq_len), tm=tm)
    return ti, operands, kw


def assert_bit_equal(got, want):
    for g, w, name in zip(got, want, ("masks", "counts", "walk_steps",
                                      "early_stops")):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g.cpu(), w.cpu()), name


@pytest.mark.parametrize("seed,measure,t", [
    (0, "jaccard", 0.5), (1, "cosine", 0.7), (2, "dice", 2 / 3),
    (3, "overlap", 0.9), (4, "jaccard", 0.9)])
def test_kernel_matches_plain(cuda, seed, measure, t):
    ti, operands, kw = walk_inputs(cuda, seed, t, measure)
    before = lfvt_walk.lfvt_walk_live_tiled.launches
    got = lfvt_walk.lfvt_walk_live_tiled(ti, *operands, **kw)
    torch.cuda.synchronize()
    assert lfvt_walk.lfvt_walk_live_tiled.launches == before + 1
    assert_bit_equal(got, lfvt_walk.lfvt_walk_live_tiled_ref(
        ti, *operands, **kw))
    cpu = [x.cpu() for x in operands]
    assert_bit_equal(got, lfvt_walk.lfvt_walk_live_tiled_ref(
        ti.cpu(), *cpu, **kw))


def test_kernel_checks_operands(cuda):
    ti, operands, kw = walk_inputs(cuda, 5, 0.5, "jaccard")
    bad = list(operands)
    bad[0] = bad[0].long()
    with pytest.raises(ValueError, match="lane_pos must be int32"):
        lfvt_walk.lfvt_walk_live_tiled(ti, *bad, **kw)
    bad = list(operands)
    bad[1] = bad[1].cpu()
    with pytest.raises(ValueError, match="lane_rem is on cpu"):
        lfvt_walk.lfvt_walk_live_tiled(ti, *bad, **kw)


@pytest.mark.parametrize("emit", ["pairs", "mask"])
def test_join_on_cuda_matches_cpu(cuda, emit):
    R, S = skewed(7, 700, 300, 40), skewed(8, 600, 300, 40)
    for measure in ("jaccard", "cosine", "dice", "overlap"):
        st_g: dict = {}
        st_c: dict = {}
        got = repro_torch.join(R, S, 0.6, method="lfvt", measure=measure,
                               emit=emit, stats=st_g, r_block=256)
        want = repro_torch.join(R, S, 0.6, method="lfvt", measure=measure,
                                emit=emit, stats=st_c, r_block=256,
                                device="cpu")
        assert st_g["device"].startswith("cuda")
        assert got.pairs == want.pairs, measure
        for key in ("pair_count", "walk_steps", "early_stops", "live_tiles",
                    "regrows"):
            assert st_g[key] == st_c[key], (measure, key)


def tiled_inputs(device, seed, m, n, universe, defaults, tiles=None):
    """Padded bitmap operands of an (m, n) block over a size-sorted S with
    its Lemma-3.1 windows at t = 0.5, plus the live tiles."""
    R = skewed(seed, m, universe, 64)
    Ss = skewed(seed + 1, n, universe, 64).sort_by_size()
    W = max((universe + 31) // 32, 1)
    lo, hi = window_bounds(R.sizes(), Ss.sizes(), 0.5)
    rb, r_sz, sb, s_sz, lo_p, hi_p, skip, tls, _, _ = ops._prepare(
        torch.tensor(R.bitmaps(W).view(np.int32), device=device), R.sizes(),
        torch.tensor(Ss.bitmaps(W).view(np.int32), device=device),
        Ss.sizes(), lo, hi, tiles, defaults)
    TM, TN, _ = tls
    ti, tj = ops._live_tiles(ops._host_rows(lo, TM), ops._host_rows(hi, TM),
                             rb.shape[0] // TM, sb.shape[0] // TN, TM, TN)
    live = (torch.tensor(ti, device=device), torch.tensor(tj, device=device))
    return (rb, r_sz, sb, s_sz, lo_p, hi_p), skip, live, tls


FAMILIES = {
    "bitmap": (bitmap_join.DEFAULT_TILES, bitmap_join.bitmap_join_tiled,
               bitmap_join.bitmap_join_tiled_ref,
               bitmap_join.bitmap_join_live_tiled,
               bitmap_join.bitmap_join_live_tiled_ref),
    "onehot": (onehot_join.DEFAULT_TILES, onehot_join.onehot_join_tiled,
               onehot_join.onehot_join_tiled_ref,
               onehot_join.onehot_join_live_tiled,
               onehot_join.onehot_join_live_tiled_ref),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("m,n,universe,tiles,measure,t", [
    (20, 300, 90, None, "jaccard", 0.5),          # (32, 256, 4)
    (20, 300, 90, (32, 128, 2), "cosine", 0.5),
    (37, 300, 200, (8, 128, 1), "dice", 0.7),
    (300, 600, 3000, None, "jaccard", 0.5),       # the default tiles
    (300, 600, 3000, None, "overlap", 0.9),
    (300, 600, 3000, None, "jaccard", 2 / 3),
    # every (TM, TN) the one-hot kernel takes, ragged in both axes, at
    # W in {1, 3, 5, 9} words (not a multiple of its 4-word stage)
    (19, 300, 32, (8, 128, 1), "jaccard", 0.5),
    (35, 300, 96, (16, 128, 1), "cosine", 0.5),
    (67, 300, 160, (32, 128, 1), "dice", 0.5),
    (131, 300, 288, (64, 128, 1), "overlap", 0.7),
    (131, 300, 32, (128, 128, 1), "jaccard", 0.5),
    (19, 520, 96, (8, 256, 1), "jaccard", 0.5),
    (35, 520, 160, (16, 256, 1), "cosine", 0.7),
    (67, 520, 288, (32, 256, 1), "dice", 0.5),
    (131, 520, 32, (64, 256, 1), "jaccard", 2 / 3),
    (260, 520, 96, (128, 256, 1), "overlap", 0.9),
])
def test_tiled_kernels_match_plain(cuda, family, m, n, universe, tiles,
                                   measure, t):
    defaults, _, _, _, _ = FAMILIES[family]
    ops_, skip, (ti, tj), tls = tiled_inputs(cuda, m + n, m, n, universe,
                                             defaults, tiles)
    assert_family_matches(family, ops_, skip, ti, tj, tls, measure, t)


def assert_family_matches(family, ops_, skip, ti, tj, tls, measure, t):
    """Both kernels of ``family`` on the padded operands, each launched
    once (the live one when there is a live tile), bit-equal to their
    plain versions; the live counts sum to the dense mask -> its pairs."""
    _, dense, dense_ref, live, live_ref = FAMILIES[family]
    kw = dict(t=t, measure=measure, tiles=tls)
    before = (dense.launches, live.launches)
    got = dense(*ops_, skip, **kw)
    got_m, got_c = live(ti, tj, *ops_, **kw)
    torch.cuda.synchronize()
    assert (dense.launches, live.launches) == (before[0] + 1,
                                               before[1] + (len(ti) > 0))
    assert torch.equal(got.cpu(), dense_ref(*ops_, skip, **kw).cpu())
    want_m, want_c = live_ref(ti, tj, *ops_, **kw)
    assert torch.equal(got_m.cpu(), want_m.cpu())
    assert torch.equal(got_c.cpu(), want_c.cpu())
    assert int(got_c.sum()) == int(got.sum())
    return int(got.sum())


def onehot_operands(device, r_bm, s_bm, lo, hi, tiles):
    """Padded one-hot operands, skip mask and live tiles of uint32 words
    (numpy) with the windows given."""
    r_sz = np.bitwise_count(r_bm).sum(1).astype(np.int32)
    s_sz = np.bitwise_count(s_bm).sum(1).astype(np.int32)
    rb, rs, sb, ss, lo_p, hi_p, skip, tls, _, _ = ops._prepare(
        torch.tensor(r_bm.view(np.int32), device=device), r_sz,
        torch.tensor(s_bm.view(np.int32), device=device), s_sz, lo, hi,
        tiles, onehot_join.DEFAULT_TILES)
    TM, TN, _ = tls
    ti, tj = ops._live_tiles(ops._host_rows(lo, TM), ops._host_rows(hi, TM),
                             rb.shape[0] // TM, sb.shape[0] // TN, TM, TN)
    return (rb, rs, sb, ss, lo_p, hi_p), skip, ti, tj, tls


@pytest.mark.parametrize("case", ["full_rows", "many_row_tiles",
                                  "shuffled_live_tiles", "exact_boundary"])
def test_onehot_kernel_edges_match_plain(cuda, case):
    """The one-hot kernels' edges, bit-equal to the plain versions: rows
    of all ones at a universe of 8 192 (counts reach the universe); more
    live tiles in one column tile (138) than a wave of CTAs (132); the
    live tiles in a random order (each tile's outputs stay at its index);
    the exact-2/3 Jaccard boundary under all four measures."""
    rng = np.random.default_rng(21)
    measures, t, tiles = ["jaccard"], 0.5, None
    if case == "full_rows":
        r_bm = rng.integers(0, 2 ** 32, (130, 256), dtype=np.uint32) & (
            rng.integers(0, 2 ** 32, (130, 256), dtype=np.uint32))
        s_bm = rng.integers(0, 2 ** 32, (300, 256), dtype=np.uint32)
        r_bm[::7] = 0xFFFFFFFF
        s_bm[::5] = 0xFFFFFFFF
        m, n = 130, 300
    elif case == "exact_boundary":
        # |R| = |S| = 5 sharing 4: Jaccard exactly 2/3
        r_bm = np.zeros((3, 2), np.uint32)
        s_bm = np.zeros((140, 2), np.uint32)
        r_bm[:, 0] = 0b11111
        s_bm[:, 0] = 0b101111
        s_bm[1::2, 1] = 0b11
        m, n = 3, 140
        measures, t = ["jaccard", "cosine", "dice", "overlap"], 2 / 3
    else:
        r_bm = rng.integers(0, 2 ** 32, (1100, 1), dtype=np.uint32)
        s_bm = rng.integers(0, 2 ** 32, (300, 1), dtype=np.uint32)
        m, n, tiles = 1100, 300, (8, 128, 1)
    lo, hi = np.zeros(m, np.int32), np.full(m, n, np.int32)
    ops_, skip, ti, tj, tls = onehot_operands(cuda, r_bm, s_bm, lo, hi,
                                              tiles)
    if case == "shuffled_live_tiles":
        perm = rng.permutation(len(ti))
        ti, tj = ti[perm], tj[perm]
    ti, tj = torch.tensor(ti, device=cuda), torch.tensor(tj, device=cuda)
    if case == "many_row_tiles":
        assert int((tj == 0).sum()) > 132
    for measure in measures:
        pairs = assert_family_matches("onehot", ops_, skip, ti, tj, tls,
                                      measure, t)
        assert pairs > 0, (case, measure)
    if case == "full_rows":
        got_m, got_c = onehot_join.onehot_join_live_tiled(
            ti, tj, *ops_, t=1.0, measure="jaccard", tiles=tls)
        # the all-ones rows against the all-ones columns, and only those
        assert int(got_c.sum()) == 19 * 60


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_tiled_kernels_check_operands(cuda, family):
    defaults, dense, _, live, _ = FAMILIES[family]
    ops_, skip, (ti, tj), tls = tiled_inputs(cuda, 3, 40, 300, 300, defaults)
    kw = dict(t=0.5, measure="jaccard", tiles=tls)
    bad = list(ops_)
    bad[0] = bad[0].long()
    with pytest.raises(ValueError, match="r_bitmaps must be int32"):
        dense(*bad, skip, **kw)
    bad = list(ops_)
    bad[4] = bad[4][:-1]
    with pytest.raises(ValueError, match="lo has shape"):
        live(ti, tj, *bad, **kw)
    with pytest.raises(ValueError, match="skip has shape"):
        dense(*ops_, skip[:, :1], **kw)
    with pytest.raises(ValueError, match="tile_j is on cpu"):
        live(ti, tj.cpu(), *ops_, **kw)
    with pytest.raises(ValueError, match="not padded"):
        dense(*ops_, skip, t=0.5, measure="jaccard",
              tiles=(tls[0], tls[1], 3))


@pytest.mark.parametrize("method", ["popcount", "onehot", "kernel_bitmap",
                                    "kernel_onehot"])
@pytest.mark.parametrize("emit", ["pairs", "mask"])
def test_bitmap_methods_on_cuda_match_cpu(cuda, method, emit):
    R, S = skewed(9, 700, 300, 40), skewed(10, 600, 300, 40)
    for measure in ("jaccard", "cosine", "dice", "overlap"):
        st_g: dict = {}
        st_c: dict = {}
        got = repro_torch.join(R, S, 0.6, method=method, measure=measure,
                               emit=emit, stats=st_g, r_block=256)
        want = repro_torch.join(R, S, 0.6, method=method, measure=measure,
                                emit=emit, stats=st_c, r_block=256,
                                device="cpu")
        assert st_g["device"].startswith("cuda")
        assert got.pairs == want.pairs and got.pairs, measure
        for key in ("pair_count", "live_tiles", "total_tiles", "regrows",
                    "output_bytes"):
            assert st_g.get(key) == st_c.get(key), (measure, key)


MR_STATS = ("result_pairs", "regrows", "live_tiles", "total_tiles",
            "walk_steps", "early_stops", "reduce_bytes", "dense_mask_bytes",
            "reduce_mask_peak_bytes", "reduce_intermediate_peak_bytes",
            "shard_block_bytes", "shard_methods", "retries",
            "degradations", "faults_injected")


@pytest.mark.parametrize("method", ["lfvt", "lfvt_ref", "popcount",
                                    "onehot", "kernel_bitmap",
                                    "kernel_onehot", "auto"])
@pytest.mark.parametrize("emit", ["pairs", "mask"])
def test_mr_join_on_cuda_matches_cpu(cuda, method, emit):
    """The MapReduce loop path on the card, every method: pairs and
    counters equal to the CPU driver's, at 4 load-aware shards and with
    all of S on every shard (hash); each shard launches its kernel."""
    from repro_torch.core.distributed import mr_cf_rs_join
    R, S = skewed(21, 600, 300, 40), skewed(22, 500, 300, 40)
    kernel = {"lfvt": lfvt_walk.lfvt_walk_live_tiled,
              "kernel_bitmap": bitmap_join.bitmap_join_live_tiled,
              "kernel_onehot": onehot_join.onehot_join_live_tiled,
              "popcount": bitmap_join.bitmap_join_tiled,
              "onehot": bitmap_join.bitmap_join_tiled}.get(method)
    if emit == "mask" and method.startswith("kernel_"):
        kernel = (bitmap_join.bitmap_join_tiled if method == "kernel_bitmap"
                  else onehot_join.onehot_join_tiled)
    for measure, strategy in (("jaccard", "load_aware"),
                              ("cosine", "hash"), ("overlap", "load_aware")):
        st_g: dict = {}
        st_c: dict = {}
        if kernel is not None:
            kernel.launches = 0
        got = mr_cf_rs_join(R, S, 0.6, 4, strategy=strategy, method=method,
                            measure=measure, emit=emit, stats=st_g)
        want = mr_cf_rs_join(R, S, 0.6, 4, strategy=strategy, method=method,
                             measure=measure, emit=emit, stats=st_c,
                             device="cpu")
        assert got == want and got, (measure, strategy)
        assert {k: st_g.get(k) for k in MR_STATS} == {
            k: st_c.get(k) for k in MR_STATS}, (measure, strategy)
        if kernel is not None:
            assert kernel.launches >= 1, (measure, strategy)


def test_mr_managed_join_on_cuda_matches_cpu(cuda):
    """A fault plan on the card: the same pairs and resilience counters
    as on the CPU (the walk degrades to the whole-block walk where the
    plan injects an OOM)."""
    from repro_torch.core.distributed import mr_cf_rs_join
    R, S = skewed(23, 400, 300, 40), skewed(24, 400, 300, 40)
    for plan in ("compact:transient;flat_tables:corrupt",
                 "walk_dispatch:oom"):
        st_g: dict = {}
        st_c: dict = {}
        got = mr_cf_rs_join(R, S, 0.6, 4, method="lfvt", stats=st_g,
                            fault_plan=plan)
        want = mr_cf_rs_join(R, S, 0.6, 4, method="lfvt", stats=st_c,
                             fault_plan=plan, device="cpu")
        assert got == want and got
        assert {k: st_g.get(k) for k in MR_STATS} == {
            k: st_c.get(k) for k in MR_STATS}, plan
        assert st_g["faults_injected"] > 0


MESH_STATS = MR_STATS + ("mesh_devices", "walk_schedule", "flat_pad_waste",
                         "n_buckets", "pad_waste_mean", "pad_waste_max")


@pytest.mark.parametrize("method,schedule", [
    ("lfvt", "planned"), ("lfvt", "static"), ("popcount", None),
    ("onehot", None), ("kernel_bitmap", None), ("kernel_onehot", None)])
@pytest.mark.parametrize("emit", ["pairs", "mask"])
def test_mesh_join_on_cuda_matches_cpu(cuda, method, schedule, emit):
    """The multi-device path on 4 slots of the card against 4 CPU slots:
    pairs and stats equal, under both walk schedules and every stacked
    method; K6 (planned), K1 (static), K3 or (``kernel_onehot``) K5
    launches at least once and at most once per shard."""
    from repro_torch.core.distributed import mr_cf_rs_join
    from repro_torch.launch.mesh import make_host_mesh
    R, S = skewed(21, 600, 300, 40), skewed(22, 500, 300, 40)
    kernel = {"planned": lfvt_walk.lfvt_walk_planned,
              "static": lfvt_walk.lfvt_walk_live_tiled}.get(
        schedule, onehot_join.onehot_join_tiled
        if method == "kernel_onehot" else bitmap_join.bitmap_join_tiled)
    kw = {"schedule": schedule} if schedule else {}
    for measure, strategy in (("jaccard", "load_aware"),
                              ("cosine", "hash"), ("overlap", "load_aware")):
        st_g: dict = {}
        st_c: dict = {}
        kernel.launches = 0
        got = mr_cf_rs_join(R, S, 0.6, 4, strategy=strategy, method=method,
                            measure=measure, emit=emit, stats=st_g,
                            mesh=make_host_mesh(4), **kw)
        launches = kernel.launches
        want = mr_cf_rs_join(R, S, 0.6, 4, strategy=strategy, method=method,
                             measure=measure, emit=emit, stats=st_c,
                             mesh=make_host_mesh(4, device="cpu"), **kw)
        assert got == want and got, (measure, strategy)
        assert {k: st_g.get(k) for k in MESH_STATS} == {
            k: st_c.get(k) for k in MESH_STATS}, (measure, strategy)
        # the masks stay on the card across a regrow, which reruns the
        # compaction only: at most one launch per shard
        assert 1 <= launches <= 4, (measure, strategy, launches)


def test_mesh_shard_body_never_waits_for_the_device(cuda):
    """One shard of a mesh bucket on the card: uploads, the entry
    lookup, the lane order, the device plan and K6 run under sync debug
    mode "error"; mask and counters equal the CPU's."""
    from repro_torch.core import distributed as dist
    from repro_torch.core.device import upload
    from repro_torch.core.partition import load_aware_partition, route
    R, S = skewed(31, 500, 300, 40), skewed(32, 400, 300, 40)
    S = S.sort_by_size()
    part = load_aware_partition(R, S, 0.6, 2)
    s_rows, r_rows, _ = route(R, S, part)
    rs = r_rows[0][np.argsort(-R.sizes()[r_rows[0]], kind="stable")]
    ss = s_rows[0]
    flat = SetCollection([S.sets[int(j)] for j in ss], S.universe,
                         S.ids[ss].astype(np.int32)).flat_lfvt()
    lr = int(R.sizes()[rs].max())
    caps = (-(-len(rs) // 16) * 16, flat.n_sets, len(flat.entry_elem),
            len(flat.seq_row), flat.max_seq_len)
    arrays, *_ = dist._lfvt_bucket_arrays(
        [(0, flat, rs, lr)], caps, lr, R.padded()[0], R.sizes(), R.ids, 0.6,
        "jaccard")
    kw = dict(t=0.6, measure="jaccard", max_steps=caps[4], tm=16)
    want = dist._lfvt_local_mask(*(torch.from_numpy(a[0]) for a in arrays),
                                 **kw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = dist._lfvt_local_mask(*(upload(a[0], cuda) for a in arrays),
                                    **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(got[0].cpu(), want[0]) and bool(want[0].any())
    assert [int(x) for x in got[1:]] == [int(x) for x in want[1:]]


@pytest.mark.parametrize("measure", ["jaccard", "overlap"])
def test_mr_popcount_shard_mask_is_k3(cuda, measure):
    """A popcount shard's dense mask (``local_join_mask``) comes from K3
    on the card, and equals ``_popcount_qualify`` over the same operands
    on the card and on the CPU."""
    from repro_torch.core.distributed import local_join_mask, shard_blocks
    from repro_torch.core.partition import load_aware_partition
    from repro_torch.core.tile_join import _popcount_qualify
    R, S = skewed(25, 500, 300, 40), skewed(26, 400, 300, 40)
    part = load_aware_partition(R, S, 0.6, 3, measure=measure)
    blocks, _ = shard_blocks(R, S, part, 0.6, pad="bucket")
    hits = 0
    for block in blocks:
        for lk in range(block.n_local):
            ops_ = block.shard(lk, cuda)
            bitmap_join.bitmap_join_tiled.launches = 0
            mask = local_join_mask(*ops_, 0.6, "popcount", measure)
            assert bitmap_join.bitmap_join_tiled.launches == 1
            r_bm, r_sz, s_bm, s_sz, lo, hi = ops_
            rows = [torch.tensor(x, device=cuda) for x in (r_sz, s_sz, lo,
                                                           hi)]
            want = _popcount_qualify(r_bm, rows[0], s_bm, rows[1], rows[2],
                                     rows[3], t=0.6, measure=measure)
            assert torch.equal(mask, want)
            cpu = [x.cpu() for x in (r_bm, *rows[:1], s_bm, *rows[1:])]
            assert torch.equal(mask.cpu(), _popcount_qualify(
                cpu[0], cpu[1], cpu[2], cpu[3], cpu[4], cpu[5], t=0.6,
                measure=measure))
            hits += int(mask.sum())
    assert hits


def test_popcount_join_on_cuda_builds_the_compressed_s_once(cuda,
                                                            monkeypatch):
    """On the card the popcount joins read S through one compressed S per
    (S, W, device), built from the cached padded sheet and reused by a
    repeated join; the one-hot joins never build it."""
    from repro_torch.core import tile_join
    R, S = skewed(11, 400, 300, 40), skewed(12, 500, 300, 40)
    built = []
    real = bitmap_join.compress_s
    monkeypatch.setattr(bitmap_join, "compress_s",
                        lambda x: built.append(x) or real(x))
    repro_torch.join(R, S, 0.6, method="onehot")
    assert not built
    first = repro_torch.join(R, S, 0.6, method="popcount")
    again = repro_torch.join(R, S, 0.6, method="kernel_bitmap")
    W = max((max(R.universe, S.universe) + 31) // 32, 1)
    entry = tile_join._S_REP_CACHE[S]
    dev = str(tile_join.resolve_device(None))
    assert len(built) == 1 and built[0] is entry[("bitmap", W, dev)]
    assert ("sparse", W, dev) in entry
    assert again.pairs == first.pairs and first.pairs


def bitmap_case(device, case):
    """Padded K2/K3 operands of a hand-made case (numpy words, S sorted by
    size, Lemma-3.1 windows at t = 0.5) -> (operands, skip, live tiles,
    tiles). "wide_words": 1 250 words (above 1 024), sparse rows; "slices":
    16-row groups whose union of nonzero words exceeds one 512-word slice
    of shared memory; "full_rows": rows and columns of all ones among
    sparse ones (a column's list holds every word)."""
    rng = np.random.default_rng(31)
    if case == "full_rows":
        m, n, W, k = 130, 300, 64, 12
    elif case == "slices":
        m, n, W, k = 40, 300, 1250, 900
    else:
        m, n, W, k = 70, 600, 1250, 20
    r_bm, s_bm = (np.zeros((rows, W), np.uint32) for rows in (m, n))
    for bm in (r_bm, s_bm):
        for row in bm:   # k random elements a row, at most
            el = rng.integers(0, 32 * W, int(rng.integers(1, k + 1)))
            np.bitwise_or.at(row, el // 32, np.uint32(1) << (el % 32))
    # pairs: R's rows, every other one with one element more
    s_bm[: n // 4] = r_bm[np.arange(n // 4) % m]
    el = rng.integers(0, 32 * W, n // 8)
    np.bitwise_or.at(s_bm, (2 * np.arange(n // 8), el // 32),
                     np.uint32(1) << (el % 32))
    if case == "full_rows":
        r_bm[::7] = 0xFFFFFFFF
        s_bm[::5] = 0xFFFFFFFF
    r_sz = np.bitwise_count(r_bm).sum(1).astype(np.int32)
    s_sz = np.bitwise_count(s_bm).sum(1).astype(np.int32)
    order = np.argsort(-s_sz, kind="stable")
    s_bm, s_sz = s_bm[order], s_sz[order]
    lo, hi = window_bounds(r_sz, s_sz, 0.5)
    rb, rs, sb, ss, lo_p, hi_p, skip, tls, _, _ = ops._prepare(
        torch.tensor(r_bm.view(np.int32), device=device), r_sz,
        torch.tensor(s_bm.view(np.int32), device=device), s_sz, lo, hi,
        (32, 128, 2) if case == "full_rows" else None,
        bitmap_join.DEFAULT_TILES)
    TM, TN, _ = tls
    ti, tj = ops._live_tiles(ops._host_rows(lo, TM), ops._host_rows(hi, TM),
                             rb.shape[0] // TM, sb.shape[0] // TN, TM, TN)
    return ((rb, rs, sb, ss, lo_p, hi_p), skip,
            (torch.tensor(ti, device=device), torch.tensor(tj, device=device)),
            tls)


@pytest.mark.parametrize("case", ["wide_words", "slices", "full_rows"])
@pytest.mark.parametrize("lists", ["passed", "built"])
def test_bitmap_kernels_on_sparse_words(cuda, case, lists):
    """K2/K3 with S's compressed words passed in (as the driver passes
    its cached ones) or built by the wrapper, bit-equal to their plain
    versions under all four measures, with pairs."""
    ops_, skip, (ti, tj), tls = bitmap_case(cuda, case)
    sp = bitmap_join.compress_s(ops_[2]) if lists == "passed" else None
    for measure in ("jaccard", "cosine", "dice", "overlap"):
        kw = dict(t=0.5, measure=measure, tiles=tls)
        before = (bitmap_join.bitmap_join_tiled.launches,
                  bitmap_join.bitmap_join_live_tiled.launches)
        got = bitmap_join.bitmap_join_tiled(*ops_, skip, s_sparse=sp, **kw)
        got_m, got_c = bitmap_join.bitmap_join_live_tiled(
            ti, tj, *ops_, s_sparse=sp, **kw)
        torch.cuda.synchronize()
        assert (bitmap_join.bitmap_join_tiled.launches,
                bitmap_join.bitmap_join_live_tiled.launches) == (
                    before[0] + 1, before[1] + 1)
        assert torch.equal(got.cpu(), bitmap_join.bitmap_join_tiled_ref(
            *ops_, skip, **kw).cpu())
        want_m, want_c = bitmap_join.bitmap_join_live_tiled_ref(
            ti, tj, *ops_, **kw)
        assert torch.equal(got_m.cpu(), want_m.cpu())
        assert torch.equal(got_c.cpu(), want_c.cpu())
        assert int(got_c.sum()) == int(got.sum()) > 0, measure


def test_bitmap_kernel_honours_a_hand_made_skip(cuda):
    """K3 leaves a tile flagged in its skip operand all False even where
    the windows meet it and pairs lie (the reference's contract), and
    computes the other tiles as its plain version does."""
    ops_, skip, _, tls = bitmap_case(cuda, "wide_words")
    kw = dict(t=0.5, measure="jaccard", tiles=tls)
    full = bitmap_join.bitmap_join_tiled(*ops_, skip, **kw)
    i, j = (int(x) for x in torch.nonzero(full)[0])
    skip = skip.clone()
    skip[i // tls[0], j // tls[1]] = 1
    got = bitmap_join.bitmap_join_tiled(*ops_, skip, **kw)
    assert torch.equal(got.cpu(), bitmap_join.bitmap_join_tiled_ref(
        *ops_, skip, **kw).cpu())
    assert not got[i, j] and int(got.sum()) < int(full.sum())


def test_bitmap_kernels_refuse_what_they_do_not_take(cuda):
    """A W past ``MAX_WORDS`` and a compressed S of too few columns raise
    named ``ValueError``s before any launch."""
    W = bitmap_join.MAX_WORDS + 8
    z = functools.partial(torch.zeros, dtype=torch.int32, device=cuda)
    args = (z((8, W)), z((8, 1)), z((128, W)), z((1, 128)), z((8, 1)),
            z((8, 1)))
    with pytest.raises(ValueError, match="MAX_WORDS"):
        bitmap_join.bitmap_join_tiled(*args, z((1, 1)), t=0.5,
                                      tiles=(8, 128, 8))
    ops_, skip, (ti, tj), tls = bitmap_case(cuda, "wide_words")
    short = bitmap_join.compress_s(ops_[2][:32])
    with pytest.raises(ValueError, match="s_sparse holds 32 columns"):
        bitmap_join.bitmap_join_live_tiled(ti, tj, *ops_, t=0.5, tiles=tls,
                                           s_sparse=short)



# ---------------------------------------------------------------------- #
# K6: the walk over a device-planned schedule, and the dedup service
# ---------------------------------------------------------------------- #
def planned_inputs(device, seed, t, measure, dead_every=0):
    """K6's operands: the walk block of ``walk_inputs`` over every row
    tile, planned on the device; with ``dead_every`` the windows of
    every ``dead_every``-th tile are emptied, so the plan is not the
    identity."""
    R = skewed(seed, 300, 200, 48)
    flat = skewed(seed + 1, 500, 200, 48).sort_by_size().flat_lfvt()
    r_sz = R.sizes()
    lo, hi = window_bounds(r_sz, flat.s_sizes, t, measure)
    _, operands, _ = ops.walk_operands(flat, torch.tensor(
        R.padded()[0], device=device), r_sz, lo, hi, 16, schedule="device")
    operands = list(operands)
    if dead_every:
        lo_p, hi_p = operands[6].clone(), operands[7].clone()
        for k in range(0, lo_p.shape[0] // 16, dead_every):
            hi_p[16 * k:16 * (k + 1)] = lo_p[16 * k:16 * (k + 1)]
        operands[7] = hi_p
    ti_sorted, n_live = lfvt_walk.plan_row_tiles_device(operands[6],
                                                        operands[7], 16)
    kw = dict(t=t, measure=measure, max_steps=int(flat.max_seq_len), tm=16)
    return ti_sorted, n_live, operands, kw


@pytest.mark.parametrize("seed", [11, 12])
@pytest.mark.parametrize("measure,t", [("jaccard", 0.5), ("cosine", 0.7)])
@pytest.mark.parametrize("dead_every", [0, 2])
def test_planned_kernel_matches_plain_and_k1(cuda, seed, measure, t,
                                             dead_every):
    ti_sorted, n_live, operands, kw = planned_inputs(cuda, seed, t, measure,
                                                     dead_every)
    before = lfvt_walk.lfvt_walk_planned.launches
    got = lfvt_walk.lfvt_walk_planned(ti_sorted, n_live, *operands, **kw)
    torch.cuda.synchronize()
    assert lfvt_walk.lfvt_walk_planned.launches == before + 1
    m_tiles = ti_sorted.shape[0]
    assert_bit_equal(got, lfvt_walk.lfvt_walk_planned_ref(
        ti_sorted, n_live, *operands, **kw))
    nl = int(n_live)
    assert 0 < nl and (nl < m_tiles) == bool(dead_every)
    live = ti_sorted[:nl].long()
    k1 = lfvt_walk.lfvt_walk_live_tiled(ti_sorted[:nl].contiguous(),
                                        *operands, **kw)
    for g, w in zip(got, k1):
        assert torch.equal(g[live].cpu(), w.cpu())
    dead = ti_sorted[nl:].long()
    for g in got:
        assert not g[dead].any()


def test_planned_kernel_checks_operands(cuda):
    ti_sorted, n_live, operands, kw = planned_inputs(cuda, 13, 0.5,
                                                     "jaccard")
    with pytest.raises(ValueError, match="n_live has shape"):
        lfvt_walk.lfvt_walk_planned(ti_sorted, n_live.reshape(1),
                                    *operands, **kw)
    with pytest.raises(ValueError, match="ti_sorted is on cpu"):
        lfvt_walk.lfvt_walk_planned(ti_sorted.cpu(), n_live, *operands,
                                    **kw)
    with pytest.raises(ValueError, match="n_live must be int32"):
        lfvt_walk.lfvt_walk_planned(ti_sorted, n_live.long(), *operands,
                                    **kw)
    with pytest.raises(lfvt_walk.TileShapeError, match="ti_sorted names"):
        lfvt_walk.lfvt_walk_planned(ti_sorted[:-1], n_live, *operands,
                                    **kw)


def test_planned_dispatch_never_waits_for_the_device(cuda):
    """The whole device-schedule dispatch (operands, uploads, plan and
    K6) runs under sync debug mode "error" once the corpus is on the
    card, and its pairs and counters are the host schedule's."""
    from repro_torch.core.device import upload
    R = skewed(14, 300, 200, 48)
    flat = skewed(15, 500, 200, 48).sort_by_size().flat_lfvt()
    r_pad, r_sz = R.padded()[0], R.sizes()
    lo, hi = window_bounds(r_sz, flat.s_sizes, 0.5, "jaccard")
    # the corpus upload is once per corpus, whichever name the card has
    assert flat.to_device(cuda) is flat.to_device(
        torch.device("cuda", torch.cuda.current_device()))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = ops.lfvt_walk_join_pairs_dispatch(
            flat, upload(r_pad, cuda), r_sz, lo, hi, 0.5,
            schedule="device")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    out = {}
    for schedule, p in (("device", pending), ("host", None)):
        p = p or ops.lfvt_walk_join_pairs_dispatch(
            flat, upload(r_pad, cuda), r_sz, lo, hi, 0.5, schedule=schedule)
        st = {}
        pairs, n = ops.join_pairs_finalize(p, stats=st)
        out[schedule] = (sorted(map(tuple, pairs[:n].cpu().tolist())),
                         {k: st[k] for k in ("pair_count", "walk_steps",
                                             "early_stops", "live_tiles")})
    assert out["device"] == out["host"] and out["device"][0]


@pytest.mark.parametrize("schedule", ["host", "device"])
@pytest.mark.parametrize("admit", ["none", "survivors"])
def test_dedup_engine_on_cuda_matches_cpu(cuda, schedule, admit):
    corpus = skewed(15, 400, 120, 24)
    rng = np.random.default_rng(16)
    reqs = [corpus.sets[i] for i in rng.choice(len(corpus), 30)]
    reqs += [np.unique(rng.integers(0, 120, int(rng.integers(1, 24))))
             for _ in range(30)]
    reqs += reqs[::7]
    out = {}
    for device in ("cuda", "cpu"):
        eng = repro_torch.DedupServeEngine(
            corpus, threshold=0.6, admit=admit, micro_batch=16,
            schedule=schedule, device=device)
        for r in reqs:
            eng.submit(r)
        res = eng.drain()
        out[device] = ([(r.rid, r.is_dup, r.matches, r.admitted,
                         r.corpus_id) for r in res], eng.stats)
    assert out["cuda"] == out["cpu"]
    assert out["cuda"][1]["dups"] > 0
    if admit == "survivors":
        assert out["cuda"][1]["admitted"] > 0


# ---------------------------------------------------------------------- #
# K1 and K6 at the edges of their run scan
# ---------------------------------------------------------------------- #
def crafted_walk(device, case):
    """Chains and lanes made to reach one edge of the kernels' run scan:
    runs shorter than the 32-position scan with hops anywhere (some
    upward), lanes that walk into position 0 with steps to spare (the
    root clamp hops it to itself; tile 0 never stops), ``max_steps``
    below the longest ``rem``, or 50 columns (the mask rows are not
    16-byte aligned). Lanes sorted by rem, as entry_state sorts them."""
    rng = np.random.default_rng({"runs_within_scan": 30, "root_clamp": 31,
                                 "max_steps_capped": 32,
                                 "columns_not_16_aligned": 34}[case])
    T, tm, Lr, M = 400, 4, 12, 16
    NP = 50 if case == "columns_not_16_aligned" else 64
    nxt = np.arange(-1, T - 1, dtype=np.int32)
    n_brk = 120 if case == "runs_within_scan" else 30
    nxt[rng.choice(np.arange(20, T), n_brk, replace=False)] = rng.integers(
        -1, T, n_brk)
    pos = rng.integers(0, T, (M, Lr)).astype(np.int32)
    rem = rng.integers(0, 150, (M, Lr)).astype(np.int32)
    lo = rng.integers(0, NP // 2, (M, 1)).astype(np.int32)
    if case == "root_clamp":
        pos[:, 0] = rng.integers(0, 10, M)
        rem[:, 0] = rng.integers(40, 150, M)
        lo[:tm] = 0
    order = np.argsort(-rem, axis=1, kind="stable")
    hi = np.minimum(lo + rng.integers(0, NP, (M, 1)), NP)
    ops_np = (np.take_along_axis(pos, order, 1),
              np.take_along_axis(rem, order, 1), nxt.reshape(1, -1),
              rng.integers(0, NP - 4, (1, T)), rng.integers(1, 20, (1, NP)),
              rng.integers(1, 20, (M, 1)), lo, hi)
    operands = [torch.tensor(np.asarray(x, np.int32), device=device)
                for x in ops_np]
    max_steps = 37 if case == "max_steps_capped" else int(rem.max()) + 5
    return operands, dict(t=0.5, measure="overlap", max_steps=max_steps,
                          tm=tm)


def table_walk(device, case):
    """The dispatch's operands for real tables: R sets of up to 700
    elements (Lr > 512); 60 000 sets over 24 elements, whose windows are
    wider than one shared-memory pass; or a table grown by appends and
    the chain re-encode fallback, whose walked hops do not all lower the
    row."""
    from repro_torch.core.lfvt_flat import IncrementalLFVT
    rng = np.random.default_rng(33)
    tm, t, lo_hi = 16, 0.2, None
    if case == "lanes_over_512":
        U = 1500
        R = SetCollection.from_ragged(
            [rng.choice(U, int(rng.integers(450, 700)), replace=False)
             for _ in range(40)], universe=U)
        flat = SetCollection.from_ragged(
            [rng.choice(U, int(rng.integers(400, 750)), replace=False)
             for _ in range(300)], universe=U).sort_by_size().flat_lfvt()
    elif case == "multi_pass_window":
        U = 24
        R = SetCollection.from_ragged(
            [rng.choice(U, int(rng.integers(1, 4)), replace=False)
             for _ in range(20)], universe=U)
        flat = SetCollection.from_ragged(
            [rng.choice(U, int(rng.integers(1, 4)), replace=False)
             for _ in range(60_000)], universe=U).sort_by_size().flat_lfvt()
    else:
        U, t = 40, 0.5
        sets = [np.unique(np.minimum(rng.zipf(1.3, int(rng.integers(
            1, 12))) - 1, U - 1)) for _ in range(300)]
        enc = IncrementalLFVT(SetCollection.from_ragged(sets, universe=U),
                              capacity_grain=8)
        enc.append([np.arange(0, 14)])
        enc.append(sets[:40] + [np.asarray([0])])
        assert enc.stats["merged_chains"]
        flat = enc.flat
        R = SetCollection.from_ragged(sets[::7], universe=U)
        lo_hi = enc.window_bounds(R.sizes(), t)
    r_sz = R.sizes()
    lo, hi = lo_hi or window_bounds(r_sz, flat.s_sizes, t)
    _, operands, _ = ops.walk_operands(flat, torch.tensor(
        R.padded()[0], device=device), r_sz, lo, hi, tm, schedule="device")
    kw = dict(t=t, measure="jaccard", max_steps=int(flat.max_seq_len),
              tm=tm)
    return list(operands), kw, flat


def walked_hops_lower(flat):
    """Whether every hop the chains of ``flat`` walk lowers the row."""
    live = flat.entry_len > 0
    pos = (flat.node_seq_off[flat.entry_node[live]]
           + flat.entry_off[live]).astype(np.int64)
    rem = flat.entry_len[live].astype(np.int64)
    ok = True
    while len(pos):
        go = rem > 1
        nxt = np.maximum(flat.seq_next[pos[go]], 0)
        ok &= bool((flat.seq_row[nxt] < flat.seq_row[pos[go]]).all())
        pos, rem = nxt, rem[go] - 1
    return ok


CRAFTED = ("runs_within_scan", "root_clamp", "max_steps_capped",
           "columns_not_16_aligned")


@pytest.mark.parametrize("case", [*CRAFTED, "lanes_over_512",
                                  "multi_pass_window", "grown_table"])
def test_walk_kernels_at_the_scan_edges(cuda, case):
    """K1 on the live tiles and K6 on the device plan, each bit-equal to
    its plain version at one edge of the run scan (K6 refuses mask rows
    that are not 16-byte aligned)."""
    if case in CRAFTED:
        operands, kw = crafted_walk(cuda, case)
    else:
        operands, kw, flat = table_walk(cuda, case)
        NP = operands[4].shape[1]
        if case == "lanes_over_512":
            assert operands[0].shape[1] > 512
        elif case == "multi_pass_window":
            cols = lfvt_walk.walk_pass_cols(NP)
            assert lfvt_walk.walk_passes(
                operands[6][:, 0].cpu().numpy(),
                operands[7][:, 0].cpu().numpy(), NP, cols).max() > 1
        else:
            assert not walked_hops_lower(flat)
    if case == "max_steps_capped":
        assert int(operands[1].max()) > kw["max_steps"]
    tm = kw["tm"]
    lo, hi = operands[6], operands[7]
    ti = torch.tensor(lfvt_walk.plan_row_tiles(
        lo[:, 0].cpu().numpy(), hi[:, 0].cpu().numpy(), tm), device=cuda)
    got = lfvt_walk.lfvt_walk_live_tiled(ti, *operands, **kw)
    torch.cuda.synchronize()
    want = lfvt_walk.lfvt_walk_live_tiled_ref(ti, *operands, **kw)
    assert_bit_equal(got, want)
    assert int(got[2].max()) > 0
    ti_sorted, n_live = lfvt_walk.plan_row_tiles_device(lo, hi, tm)
    if case == "columns_not_16_aligned":
        with pytest.raises(ValueError, match="not a multiple of 16"):
            lfvt_walk.lfvt_walk_planned(ti_sorted, n_live, *operands, **kw)
        return
    got = lfvt_walk.lfvt_walk_planned(ti_sorted, n_live, *operands, **kw)
    torch.cuda.synchronize()
    assert_bit_equal(got, lfvt_walk.lfvt_walk_planned_ref(
        ti_sorted, n_live, *operands, **kw))


# ---------------------------------------------------------------------- #
# K7: flash attention, and the LLM serving engine on the card
# ---------------------------------------------------------------------- #
# the reference's own tolerances (tests/test_flash_attention.py): float32
# differs from the full softmax only in summation order and exp; bfloat16
# rounds p to bfloat16 before P.V where the plain version keeps float32
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def flash_inputs(device, seed, bh, lpad, d, dtype):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.normal(size=(bh, lpad, d)).astype(np.float32),
                         device=device).to(dtype) for _ in range(3)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l,lpad,d,window", [
    (64, 64, 16, None), (70, 70, 32, None), (70, 128, 64, None),
    (200, 200, 128, None), (200, 200, 64, 24), (130, 130, 16, 8),
    (300, 300, 128, 100), (64, 64, 128, 64), (1, 64, 32, None),
    (129, 192, 128, 5), (255, 256, 16, None), (333, 333, 32, 40),
    (520, 640, 64, 130)])
def test_flash_kernel_matches_plain(cuda, dtype, l, lpad, d, window):
    """The merged layout: causal, ragged (l not a multiple of 64 or 128,
    and l_real < Lpad), windowed (down to a window far smaller than one
    key block), at every head dim the kernel takes."""
    q, k, v = flash_inputs(cuda, l + d, 3, lpad, d, dtype)
    before = fa.flash_attention_bhld.launches
    got = fa.flash_attention_bhld(q, k, v, scale=d ** -0.5, window=window,
                                  l_real=l)
    torch.cuda.synchronize()
    assert fa.flash_attention_bhld.launches == before + 1
    assert got.dtype == dtype and got.shape == (3, lpad, d)
    want = fa.flash_attention_bhld_ref(q, k, v, scale=d ** -0.5,
                                       window=window, l_real=l)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got[:, :l].float(), want[:, :l].float(),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,l,h,kv,d,window", [
    pytest.param(2, 100, 3, 3, 32, None, id="None"),
    pytest.param(2, 100, 3, 3, 32, 40, id="40"),
    (1, 300, 12, 2, 128, None), (2, 190, 4, 2, 64, 7),
    (3, 77, 6, 1, 16, None), (1, 513, 12, 2, 128, 100),
    (2, 64, 2, 1, 32, 200)])
def test_flash_ops_layout_on_cuda(cuda, dtype, b, l, h, kv, d, window):
    """``ops.flash_attention`` in the (B, L, H, D) layout, K and V at KV
    heads (GQA groups 1, 2 and 6, read in place): one launch, equal to
    the (B, L, H, D) oracle and to the CPU's plain path."""
    rng = np.random.default_rng(9 + l)

    def draw(heads):
        return torch.tensor(rng.normal(size=(b, l, heads, d)).astype(
            np.float32), device=cuda).to(dtype)
    qkv = [draw(h), draw(kv), draw(kv)]
    before = fa.flash_attention_bhld.launches
    got = ops.flash_attention(*qkv, window=window)
    assert fa.flash_attention_bhld.launches == before + 1
    assert got.shape == (b, l, h, d) and got.dtype == dtype
    want = ops.flash_attention_ref(*qkv, window=window)
    cpu = ops.flash_attention(*(x.cpu() for x in qkv), window=window)
    tol = FLASH_TOL[dtype]
    for other in (want, cpu):
        torch.testing.assert_close(got.float().cpu(), other.float().cpu(),
                                   atol=tol, rtol=tol)


def test_flash_gqa_reads_strided_operands(cuda):
    """q, k, v as views of one fused projection (B, L, H + 2 KV, D):
    read through their strides, no copy, equal to the contiguous call."""
    rng = np.random.default_rng(3)
    fused = torch.tensor(rng.normal(size=(2, 150, 16, 128)).astype(
        np.float32), device=cuda).to(torch.bfloat16)
    q, k, v = fused[:, :, :12], fused[:, :, 12:14], fused[:, :, 14:]
    got = ops.flash_attention(q, k, v)
    want = ops.flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous())
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_flash_kernel_checks_operands(cuda):
    q, k, v = flash_inputs(cuda, 0, 2, 64, 32, torch.bfloat16)
    call = fa.flash_attention_bhld
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        call(q.half(), k.half(), v.half(), scale=0.1)
    with pytest.raises(ValueError, match="head dim"):
        call(*flash_inputs(cuda, 0, 2, 64, 48, torch.bfloat16), scale=0.1)
    with pytest.raises(ValueError, match="k must be bfloat16"):
        call(q, k.float(), v, scale=0.1)
    with pytest.raises(ValueError, match="v has shape"):
        call(q, k, v[:, :32], scale=0.1)
    with pytest.raises(ValueError, match="not contiguous"):
        call(q.transpose(0, 1).contiguous().transpose(0, 1), k, v, scale=0.1)
    buf = torch.zeros(1 + q.numel(), dtype=q.dtype, device=cuda)
    with pytest.raises(ValueError, match="16-byte aligned"):
        call(buf[1:].view(q.shape), k, v, scale=0.1)
    with pytest.raises(ValueError, match="l_real"):
        call(q, k, v, scale=0.1, l_real=65)
    with pytest.raises(ValueError, match="window"):
        call(q, k, v, scale=0.1, window=0)
    with pytest.raises(ValueError, match="(q|k) is on"):
        call(q, k.cpu(), v, scale=0.1)
    # the (B, L, H, D) entry point: KV heads that do not divide H, and
    # strides the tensor maps cannot take
    q4, k4 = (torch.zeros(1, 64, n, 32, device=cuda, dtype=q.dtype)
              for n in (6, 4))
    with pytest.raises(ValueError, match="do not divide"):
        ops.flash_attention(q4, k4, k4)
    padded = torch.zeros(1, 64, 2, 33, device=cuda, dtype=q.dtype)[..., :32]
    with pytest.raises(ValueError, match="16-byte strides"):
        ops.flash_attention(q4, padded, padded)
    with pytest.raises(ValueError, match="k must be bfloat16"):
        ops.flash_attention(q4, k4[:, :, :2].float(), k4[:, :, :2])


# teacher-forced logits of the card and the CPU agree within this (16
# bfloat16 ulps at the smoke models' logit magnitude of 2-4: cuBLAS and
# the CPU sum in other orders, and K7 rounds p to bfloat16 where the
# CPU's plain version does not); greedy tokens may then differ only where
# the top-2 gap is at most twice that
LOGIT_TOL = 0.25


@pytest.mark.parametrize("name", ["qwen2-1.5b", "starcoder2-3b"])
def test_serve_engine_on_cuda_matches_cpu(cuda, name):
    import dataclasses
    from repro_torch.models.params import init_params
    cfg = dataclasses.replace(repro_torch.get_config(name, smoke=True),
                              attn_impl="flash")
    model = repro_torch.build_model(cfg)
    params = {dev: init_params(model.param_specs(),
                               torch.Generator().manual_seed(0), device=dev)
              for dev in ("cpu", "cuda")}
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (16, 14)).astype(np.int32)
    out = {}
    for dev in ("cpu", "cuda"):
        eng = repro_torch.ServeEngine(model, params[dev], max_seq_len=48)
        assert eng.device.type == dev
        before = fa.flash_attention_bhld.launches
        out[dev] = eng.generate(prompts, max_new_tokens=12)
        assert fa.flash_attention_bhld.launches - before == (
            cfg.n_layers if dev == "cuda" else 0)
    # teacher-forced along the CPU's tokens: logit errors and CPU gaps
    states, logits = {}, {}
    for dev in ("cpu", "cuda"):
        logits[dev], states[dev] = model.prefill(
            params[dev], torch.from_numpy(prompts).to(dev), 48)
    gaps, err = [], 0.0
    for step in range(12):
        want = logits["cpu"][:, -1].float()
        err = max(err, float((logits["cuda"][:, -1].float().cpu() - want)
                             .abs().max()))
        top2 = want.topk(2, dim=-1).values
        gaps.append((top2[:, 0] - top2[:, 1]).numpy())
        tok = torch.from_numpy(out["cpu"][:, step:step + 1])
        for dev in ("cpu", "cuda"):
            logits[dev], states[dev] = model.decode_step(
                params[dev], tok.to(dev), 14 + step, states[dev])
    assert err <= LOGIT_TOL, err
    gaps = np.stack(gaps, axis=1)
    compared = 0
    for i in range(16):
        k = 0
        while k < 12 and gaps[i, k] > 2 * LOGIT_TOL:
            k += 1
        np.testing.assert_array_equal(out["cuda"][i, :k], out["cpu"][i, :k])
        compared += k
    assert compared > 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,l,h,kv,window", [
    pytest.param(1, 2100, 4, 1, None, id="causal-ragged-mqa"),
    pytest.param(2, 4100, 3, 1, 2048, id="window2048-ragged-mqa"),
    pytest.param(1, 700, 4, 2, 5, id="window5-gqa"),
    pytest.param(2, 64, 2, 2, None, id="one-block")])
def test_flash_kernel_at_head_dim_256(cuda, dtype, b, l, h, kv, window):
    """K7 at D = 256 (RecurrentGemma's local attention: MQA, window
    2 048), causal and windowed, L not a multiple of the 64-row tiles or
    64-key blocks: one launch, within the reference's tolerance of the
    plain version; the merged layout too."""
    rng = np.random.default_rng(l + h)

    def draw(heads):
        return torch.tensor(rng.normal(size=(b, l, heads, 256)).astype(
            np.float32), device=cuda).to(dtype)
    q, k, v = draw(h), draw(kv), draw(kv)
    before = fa.flash_attention_bhld.launches
    got = ops.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention_bhld.launches == before + 1
    assert got.shape == (b, l, h, 256) and got.dtype == dtype
    want = ops.flash_attention_ref(q, k, v, window=window)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    del want
    qm = q[:1, :, :1].reshape(1, l, 256).contiguous()
    km = k[:1, :, :1].reshape(1, l, 256).contiguous()
    vm = v[:1, :, :1].reshape(1, l, 256).contiguous()
    got = fa.flash_attention_bhld(qm, km, vm, scale=256 ** -0.5,
                                  window=window, l_real=l - 3)
    want = fa.flash_attention_bhld_ref(qm, km, vm, scale=256 ** -0.5,
                                       window=window)
    torch.testing.assert_close(got[:, :l - 3].float(),
                               want[:, :l - 3].float(), atol=tol, rtol=tol)


# the families on the card against the CPU, float32 (K7's float32 kernel,
# cuBLAS in full float32): logits and decode states within this fraction
# of their largest magnitude (summation order through 2-4 layers)
FAMILY_TOL = 1e-4
MODEL_FAMILIES = ("phi3.5-moe-42b-a6.6b", "qwen2-moe-a2.7b",
                  "recurrentgemma-2b", "xlstm-350m", "llava-next-34b",
                  "musicgen-large")


@pytest.mark.parametrize("name", MODEL_FAMILIES)
def test_family_step_on_cuda_matches_cpu(cuda, name):
    """Prefill and one decode step of each family's smoke config on the
    card against the CPU, same float32 weights; llava's smoke head dim
    (8) is raised to 16, which K7 takes. K7 launches once per attention
    layer in the card's prefill."""
    import dataclasses
    from repro_torch.models.frontend import make_frontend_stub
    from repro_torch.models.params import init_params, tree_leaves
    cfg = dataclasses.replace(repro_torch.get_config(name, smoke=True),
                              attn_impl="flash")
    if cfg.resolved_head_dim not in fa.HEAD_DIMS:
        cfg = dataclasses.replace(cfg, head_dim=16)
    model = repro_torch.build_model(cfg)
    prompts = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (3, 20)).astype(np.int32))
    extra = make_frontend_stub(cfg, 3, np.random.default_rng(3),
                               device="cpu").get("extra_embeds")
    n_attn = cfg.layer_kinds().count("attn")
    out = {}
    for dev in ("cpu", "cuda"):
        p = init_params(model.param_specs(),
                        torch.Generator().manual_seed(1), torch.float32,
                        device=dev)
        before = fa.flash_attention_bhld.launches
        logits, state = model.prefill(
            p, prompts.to(dev), 64, dtype=torch.float32,
            extra_embeds=None if extra is None else extra.to(dev))
        assert fa.flash_attention_bhld.launches - before == (
            n_attn if dev == "cuda" else 0)
        pos = prompts.shape[1] + (0 if extra is None else extra.shape[1])
        if dev == "cpu":   # both decode the CPU's greedy token
            tok = logits[:, -1].argmax(dim=-1, keepdim=True).int()
        step, state = model.decode_step(p, tok.to(dev), pos, state)
        out[dev] = [logits, step] + tree_leaves(state)
    for got, want in zip(out["cuda"], out["cpu"]):
        scale = max(float(want.abs().max()), 1.0)
        assert float((got.cpu().float() - want.float()).abs().max()) <= (
            FAMILY_TOL * scale)


# ---------------------------------------------------------------------- #
# training (the train step, checkpoints and the entry point on the card)
TRAIN_GRAD_TOL = 1e-4   # float32 card vs CPU, of each leaf's largest |g|


def test_k7_refuses_autograd_on_the_card(cuda):
    """Both K7 entry points raise NoBackwardError on CUDA tensors that
    require grad under grad mode, before any launch; under no_grad the
    kernel runs and matches its plain version as before."""
    from repro_torch.errors import NoBackwardError
    g = torch.Generator(device=cuda).manual_seed(4)
    q, k, v = (torch.randn((2, 96, n, 64), generator=g, device=cuda)
               .bfloat16() for n in (4, 2, 2))
    merged = [torch.randn((8, 96, 64), generator=g, device=cuda).bfloat16()
              for _ in range(3)]
    before = fa.flash_attention_bhld.launches
    for x in (q, merged[0]):
        x.requires_grad_()
    with pytest.raises(NoBackwardError, match="no backward"):
        fa.flash_attention_blhd(q, k, v, scale=0.125)
    with pytest.raises(NoBackwardError):
        fa.flash_attention_bhld(*merged, scale=0.125)
    assert fa.flash_attention_bhld.launches == before
    with torch.no_grad():
        got = fa.flash_attention_blhd(q, k, v, scale=0.125)
    assert fa.flash_attention_bhld.launches == before + 1
    assert got.grad_fn is None
    want = fa.flash_attention_blhd_ref(q.detach(), k, v, scale=0.125)
    assert float((got.float() - want.float()).abs().max()) <= 2e-2 * (
        1 + float(want.float().abs().max()))


def _smoke_train_setup(dev, remat="none"):
    import dataclasses
    from repro_torch.models.params import init_params
    cfg = dataclasses.replace(repro_torch.get_config("qwen2-1.5b",
                                                     smoke=True), remat=remat)
    model = repro_torch.build_model(cfg)
    params = init_params(model.param_specs(),
                         torch.Generator().manual_seed(5), torch.float32,
                         device=dev)
    batch = repro_torch.TokenStream(cfg.vocab_size, 4, 32, seed=5,
                                    device=dev).batch_at(0)
    return model, params, batch


@pytest.mark.parametrize("remat", ["none", "dots", "full"])
def test_grads_on_cuda_match_cpu(cuda, remat):
    """The smoke model's loss and every gradient leaf, float32, on the card
    against the CPU, under each remat mode."""
    from repro_torch.train.trainer import make_grad_fn
    out = {}
    for dev in ("cpu", "cuda"):
        model, params, batch = _smoke_train_setup(dev, remat)
        out[dev] = make_grad_fn(model, microbatches=2)(params, batch)
    assert abs(float(out["cuda"][0]) - float(out["cpu"][0])) <= 1e-5 * abs(
        float(out["cpu"][0]))
    for got, want in zip(out["cuda"][2], out["cpu"][2]):
        assert got.device.type == "cuda" and got.dtype == torch.float32
        assert float((got.cpu() - want).abs().max()) <= TRAIN_GRAD_TOL * max(
            float(want.abs().max()), 1e-30)


def test_train_step_on_cuda_matches_cpu(cuda):
    """One AdamW step from one float32 state on the card and on the CPU:
    lr bit-equal; Adam's first step moves each weight by ~lr g / (|g| +
    eps), so a gradient near 0 (against eps = 1e-8) can move its weight by
    up to 2 x lr the other way: the master weights within 2 x lr, and
    99.9 % of them within 0.01 x lr; the params bf16 after it on both."""
    from repro_torch.models.params import tree_leaves
    from repro_torch.train.optimizer import adamw_init
    cfg = repro_torch.AdamWConfig(lr=1e-3, warmup_steps=1)
    out = {}
    for dev in ("cpu", "cuda"):
        model, params, batch = _smoke_train_setup(dev)
        state = {"params": params, "opt": adamw_init(params)}
        out[dev] = repro_torch.make_train_step(model, cfg)(state, batch)
    assert float(out["cuda"][1]["lr"]) == float(out["cpu"][1]["lr"])
    assert out["cuda"][0]["opt"]["step"].dtype == torch.int32
    d = torch.cat([(got.cpu() - want).abs().flatten() for got, want in zip(
        tree_leaves(out["cuda"][0]["opt"]["master"]),
        tree_leaves(out["cpu"][0]["opt"]["master"]))])
    assert float(d.max()) <= 2 * 1e-3
    assert float((d > 0.01 * 1e-3).double().mean()) <= 1e-3
    assert all(p.dtype == torch.bfloat16 and p.device.type == "cuda"
               for p in tree_leaves(out["cuda"][0]["params"]))


def test_launch_train_runs_on_the_card_and_resumes(cuda, tmp_path, capsys):
    """The entry point with no --device trains on the card, checkpoints,
    and a second run resumes; the checkpoint restores onto the card from
    meta targets, and TokenStream's default device is the card."""
    from repro_torch.launch.train import main
    from repro_torch.models.params import tree_leaves
    from repro_torch.train.trainer import abstract_train_state
    args = ["--arch", "qwen2-1.5b", "--smoke", "--batch", "2", "--seq", "32",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    assert main(args + ["--steps", "4"]) == 0
    assert main(args + ["--steps", "6"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert "resumed from checkpoint at step 4" in lines
    assert lines[-1].startswith("step=6 loss=")
    mgr = repro_torch.CheckpointManager(str(tmp_path))
    model = repro_torch.build_model(repro_torch.get_config("qwen2-1.5b",
                                                           smoke=True))
    state = mgr.restore(6, abstract_train_state(model))
    assert all(t.device.type == "cuda" for t in tree_leaves(state))
    assert repro_torch.TokenStream(10, 1, 4).batch_at(0)["tokens"].is_cuda
