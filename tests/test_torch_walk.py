"""PyTorch port vs JAX package: the live row-tiled walk (kernel K1).

The port's plain PyTorch version ``lfvt_walk_live_tiled_ref`` is held
against the reference's jnp twin ``lfvt_walk_live_tiled_ref`` and against
the reference's Pallas kernel ``lfvt_walk_live_tiled`` run in interpret
mode (as the reference's own tests run it), on the same numpy operands:
masks, per-tile counts, ``walk_steps`` and ``early_stops`` must be equal.
The CUDA kernel is held against the plain version in
``tests/test_torch_cuda.py`` (marker ``cuda``), which needs a GPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sets import SetCollection as RefCollection
from repro.core.tile_join import window_bounds
from repro.kernels import lfvt_walk as ref_walk
from repro_torch.kernels import _build
from repro_torch.kernels import lfvt_walk as port_walk


def ragged(seed, n, universe, max_size, skew=True):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        size = (int(min(max_size, rng.zipf(1.5))) if skew
                else int(rng.integers(0, max_size + 1)))
        out.append(rng.integers(0, universe, size=size))
    return out


def operands(R_sets, S_sets, universe, t, measure, tm=8):
    """The walk's operands for one R block, built as the dispatch builds
    them (size-sorted rows, tile padding, live tiles, resolved lanes),
    as numpy int32 arrays, plus the static arguments."""
    R = RefCollection.from_ragged(R_sets, universe=universe)
    S = RefCollection.from_ragged(S_sets, universe=universe)
    flat = S.sort_by_size().flat_lfvt()
    r_pad, r_sz = R.padded()
    lo, hi = window_bounds(r_sz, flat.s_sizes, t, measure)
    m = len(R)
    order = np.argsort(-r_sz, kind="stable")
    pad = (-m) % tm
    z = np.zeros(pad, np.int64)
    lo_p = np.concatenate([lo[order], z])
    hi_p = np.concatenate([hi[order], z])
    sz_p = np.concatenate([r_sz[order], z])
    ti = ref_walk.plan_row_tiles(lo_p, hi_p, tm)
    r_perm = np.pad(r_pad[order], ((0, pad), (0, 0)), constant_values=-1)
    pos, rem = ref_walk.entry_state(flat.to_device(), jnp.asarray(r_perm))

    def row2d(a):
        a = np.asarray(a, np.int32)
        return np.pad(a, (0, (-len(a)) % 128)).reshape(1, -1)

    ops = dict(ti=ti, lane_pos=np.asarray(pos), lane_rem=np.asarray(rem),
               nxt2d=row2d(flat.seq_next), seq2d=row2d(flat.seq_row),
               ssz2d=row2d(flat.s_sizes))
    ops.update({k: v.astype(np.int32).reshape(-1, 1)
                for k, v in (("rsz", sz_p), ("lo", lo_p), ("hi", hi_p))})
    kw = dict(t=t, measure=measure, max_steps=int(flat.max_seq_len), tm=tm)
    return ops, kw


def run_ref(ops, kw, interpret=False):
    args = [jnp.asarray(v) for v in ops.values()]
    if interpret:
        out = ref_walk.lfvt_walk_live_tiled(*args, interpret=True, **kw)
    else:
        out = ref_walk.lfvt_walk_live_tiled_ref(*args, **kw)
    return [np.asarray(x) for x in out]


def run_port(ops, kw, device="cpu", fn=None):
    fn = fn or port_walk.lfvt_walk_live_tiled_ref
    args = [torch.tensor(v, device=device) for v in ops.values()]
    return [x.cpu().numpy() for x in fn(*args, **kw)]


def assert_same(got, want):
    names = ("masks", "counts", "walk_steps", "early_stops")
    for g, w, name in zip(got, want, names):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("seed,measure,t", [
    (0, "jaccard", 0.5), (1, "cosine", 0.7), (2, "dice", 2 / 3),
    (3, "overlap", 0.9), (4, "jaccard", 2 / 3), (5, "jaccard", 0.9)])
def test_plain_walk_matches_reference_twin(seed, measure, t):
    ops, kw = operands(ragged(seed, 45, 30, 14), ragged(seed + 50, 33, 30, 14),
                       30, t, measure)
    assert len(ops["ti"]) > 1
    assert_same(run_port(ops, kw), run_ref(ops, kw))


@pytest.mark.parametrize("seed,measure,t", [
    (6, "jaccard", 0.5), (7, "cosine", 2 / 3), (8, "overlap", 0.7)])
def test_plain_walk_matches_reference_pallas_interpret(seed, measure, t):
    """Against the TPU kernel itself, run by the Pallas interpreter."""
    ops, kw = operands(ragged(seed, 20, 24, 10), ragged(seed + 50, 18, 24, 10),
                       24, t, measure)
    assert_same(run_port(ops, kw), run_ref(ops, kw, interpret=True))


def _early_stop_case():
    K = 16
    S = [np.arange(i + 1) for i in range(K)]  # sizes 1..K, element 0 in all
    R = [np.array([0, 1])] * 4 + [np.arange(9)] * 4  # two row tiles
    return R, S, K + 4


def _dead_lanes_case():
    # live windows, but no R element occurs in S: every lane parks at 0
    S = [np.arange(4) + 8 * i for i in range(6)]
    R = [np.array([100, 101, 102, 103])] * 5
    return R, S, 128


def _hot_element_case():
    # one element in every S set: a long chain next to short ones
    rng = np.random.default_rng(9)
    S = [np.unique(np.r_[0, rng.integers(1, 64, size=int(rng.integers(1, 9)))])
         for _ in range(40)]
    R = [np.unique(np.r_[0, rng.integers(1, 64, size=int(rng.integers(1, 9)))])
         for _ in range(24)]
    return R, S, 64


@pytest.mark.parametrize("case", ["early_stop", "dead_lanes", "hot_element"])
def test_plain_walk_degenerate_and_early_stop(case):
    R, S, universe = {"early_stop": _early_stop_case,
                      "dead_lanes": _dead_lanes_case,
                      "hot_element": _hot_element_case}[case]()
    ops, kw = operands(R, S, universe, 0.5, "jaccard", tm=4)
    want = run_ref(ops, kw)
    assert_same(run_port(ops, kw), want)
    assert_same(run_port(ops, kw), run_ref(ops, kw, interpret=True))
    if case == "early_stop":
        # Theorem 3.3: the small sets' lanes stop at the window exit, long
        # before the longest chain is walked
        assert want[3].sum() > 0
        assert 0 < want[2].min() < kw["max_steps"]
    if case == "dead_lanes":
        assert want[2].sum() == 0 and not want[0].any()


def test_wrapper_on_cpu_runs_the_plain_version():
    ops, kw = operands(ragged(10, 30, 30, 12), ragged(11, 25, 30, 12), 30,
                       0.5, "jaccard")
    before = port_walk.lfvt_walk_live_tiled.launches
    assert_same(run_port(ops, kw, fn=port_walk.lfvt_walk_live_tiled),
                run_port(ops, kw))
    assert port_walk.lfvt_walk_live_tiled.launches == before


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    """No silent fallback: a missing compiler is a named error."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.build()
    assert _build.library_path("lfvt_walk").name.startswith("lfvt_walk-")


# ---------------------------------------------------------------------- #
# the device-planned schedule (kernel K6's plain version)
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("tm", (1, 4, 16))
def test_device_plan_matches_reference_fuzz(tm):
    """The whole ``ti_sorted`` (the dead tail included) and ``n_live``
    equal the reference's, with dead tiles anywhere, not only last."""
    rng = np.random.default_rng(tm)
    for _ in range(25):
        m_tiles = int(rng.integers(1, 12))
        m = m_tiles * tm
        lo = rng.zipf(1.5, m).astype(np.int64) % 37
        hi = lo + rng.integers(0, 3, m)
        for _ in range(int(rng.integers(0, m_tiles + 1))):
            k = int(rng.integers(0, m_tiles))  # a dead tile, anywhere
            hi[k * tm:(k + 1) * tm] = lo[k * tm:(k + 1) * tm]
        want_ti, want_n = ref_walk.plan_row_tiles_device(
            jnp.asarray(lo), jnp.asarray(hi), tm)
        got_ti, got_n = port_walk.plan_row_tiles_device(
            torch.tensor(lo).reshape(-1, 1).to(torch.int32),
            torch.tensor(hi).reshape(-1, 1).to(torch.int32), tm)
        assert got_ti.dtype == torch.int32 and got_n.dtype == torch.int32
        assert got_n.shape == ()
        np.testing.assert_array_equal(got_ti.numpy(), np.asarray(want_ti))
        assert int(got_n) == int(want_n)
        np.testing.assert_array_equal(got_ti[:int(got_n)].numpy(),
                                      port_walk.plan_row_tiles(lo, hi, tm))
    with pytest.raises(port_walk.TileShapeError,
                       match="plan_row_tiles_device"):
        port_walk.plan_row_tiles_device(torch.zeros(10), torch.ones(10), 4)


def planned_operands(seed, measure, t, tm=4, dead=(1,)):
    """K1's operands over every row tile, with the windows of the tiles
    in ``dead`` emptied (so the live tiles are not a prefix) -> (numpy
    operands without the tile list, static arguments, m_tiles)."""
    ops, kw = operands(ragged(seed, 29, 30, 12), ragged(seed + 50, 25, 30, 12),
                       30, t, measure, tm=tm)
    ops.pop("ti")
    for k in dead:
        ops["hi"][k * tm:(k + 1) * tm] = ops["lo"][k * tm:(k + 1) * tm]
    return ops, kw, ops["lo"].shape[0] // tm


def run_planned(ops, kw, tm, which="port", chunk=None):
    """The planned walk's outputs as numpy: the port's plain version, the
    reference's (walking its live prefix in ``chunk``-tile slices) or
    the reference's Pallas kernel in interpret mode."""
    lo, hi = ops["lo"], ops["hi"]
    if which == "port":
        args = [torch.tensor(v) for v in ops.values()]
        ti, n = port_walk.plan_row_tiles_device(args[-2], args[-1], tm)
        out = port_walk.lfvt_walk_planned_ref(ti, n, *args, **kw)
        return [x.numpy() for x in out]
    args = [jnp.asarray(v) for v in ops.values()]
    ti, n = ref_walk.plan_row_tiles_device(jnp.asarray(lo), jnp.asarray(hi),
                                           tm)
    if which == "pallas":
        out = ref_walk.lfvt_walk_planned(ti, n, *args, interpret=True, **kw)
    else:
        out = ref_walk.lfvt_walk_planned_ref(ti, n, *args, chunk=chunk, **kw)
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("seed,measure,t", [
    (20, "jaccard", 0.5), (21, "cosine", 2 / 3), (22, "overlap", 0.7)])
@pytest.mark.parametrize("chunk", [1, 3, None])
def test_planned_plain_matches_reference_twin(seed, measure, t, chunk):
    """The port walks the live prefix in one call; the reference in
    ``chunk``-tile slices whose last one clamps into the tail. Every
    chunk gives the port's outputs."""
    ops, kw, m_tiles = planned_operands(seed, measure, t)
    want = run_planned(ops, kw, 4, "ref", chunk or m_tiles)
    assert_same(run_planned(ops, kw, 4), want)
    assert not want[0][1].any() and not want[2][1].any()  # tile 1 dead


@pytest.mark.parametrize("seed,measure,t", [
    (23, "jaccard", 0.5), (24, "dice", 2 / 3)])
def test_planned_plain_matches_reference_pallas_interpret(seed, measure, t):
    """Against the TPU kernel itself, run by the Pallas interpreter."""
    ops, kw, _ = planned_operands(seed, measure, t, dead=(0, 2))
    assert_same(run_planned(ops, kw, 4), run_planned(ops, kw, 4, "pallas"))


def test_planned_live_tiles_equal_the_host_walk():
    """On the live tiles the planned walk equals K1's plain version over
    the host plan; every dead tile is zero."""
    ops, kw, m_tiles = planned_operands(25, "jaccard", 0.5, dead=(0, 3))
    planned = run_planned(ops, kw, 4)
    live = port_walk.plan_row_tiles(ops["lo"][:, 0], ops["hi"][:, 0], 4)
    host = run_port(dict(ti=live, **ops), kw)
    for g, w in zip(planned, host):
        np.testing.assert_array_equal(g[live], w)
    dead = np.setdiff1d(np.arange(m_tiles), live)
    assert len(dead) >= 2
    for g in planned:
        assert not g[dead].any()


def test_planned_wrapper_on_cpu_runs_the_plain_version():
    ops, kw, _ = planned_operands(26, "jaccard", 0.5)
    args = [torch.tensor(v) for v in ops.values()]
    ti, n = port_walk.plan_row_tiles_device(args[-2], args[-1], 4)
    before = port_walk.lfvt_walk_planned.launches
    got = port_walk.lfvt_walk_planned(ti, n, *args, **kw)
    assert_same([x.numpy() for x in got],
                [x.numpy() for x in port_walk.lfvt_walk_planned_ref(
                    ti, n, *args, **kw)])
    assert port_walk.lfvt_walk_planned.launches == before
    with pytest.raises(ValueError, match="no kernel for meta"):
        port_walk.lfvt_walk_planned(
            ti, n, *[a.to("meta") for a in args], **kw)


# ---------------------------------------------------------------------- #
# dispatch: schedule="device" against "host" and the reference ops
# ---------------------------------------------------------------------- #
def _dead_band_case():
    """Shared base sets plus a band of oversized rows whose windows are
    empty at t = 0.6: whole row tiles die."""
    rng = np.random.default_rng(7)
    base = [np.unique(rng.integers(0, 128, 8)) for _ in range(10)]
    band = [np.arange(i, i + 80) for i in rng.integers(0, 40, 32)]
    R = [base[i % 10] for i in range(30)] + band
    S = [base[i % 10] for i in range(20)]
    return R, S, 128


@pytest.mark.parametrize("measure", ["jaccard", "cosine"])
def test_dispatch_device_schedule_matches_host_and_reference(measure):
    from repro.core.tile_join import window_bounds as ref_wb
    from repro.kernels import ops as ref_ops
    from repro_torch.core.sets import SetCollection
    from repro_torch.kernels import ops as port_ops
    R_sets, S_sets, U = _dead_band_case()
    t = 0.6
    Rr = RefCollection.from_ragged(R_sets, universe=U)
    flat_ref = RefCollection.from_ragged(S_sets, universe=U).flat_lfvt()
    flat = SetCollection.from_ragged(S_sets, universe=U).flat_lfvt()
    r_pad, r_sz = Rr.padded()
    lo, hi = ref_wb(r_sz, flat_ref.s_sizes, t, measure)
    keys = ("pair_count", "live_tiles", "total_tiles", "walk_steps",
            "early_stops", "regrows", "walk_vmem_tile_bytes", "counts_bytes")
    got = {}
    for schedule in ("host", "device"):
        st_ref: dict = {}
        p_ref, n_ref = ref_ops.lfvt_walk_join_pairs(
            flat_ref, r_pad, r_sz, lo, hi, t, stats=st_ref, measure=measure,
            impl="jnp", schedule=schedule)
        st: dict = {}
        pending = port_ops.lfvt_walk_join_pairs_dispatch(
            flat, torch.tensor(r_pad), r_sz, lo, hi, t, measure=measure,
            schedule=schedule)
        pairs, n = port_ops.join_pairs_finalize(pending, stats=st)
        assert n == n_ref > 0
        np.testing.assert_array_equal(pairs.numpy(), np.asarray(p_ref))
        for k in keys:
            assert st[k] == st_ref[k], (schedule, k)
        mask = port_ops.join_mask_finalize(
            port_ops.lfvt_walk_join_pairs_dispatch(
                flat, torch.tensor(r_pad), r_sz, lo, hi, t, measure=measure,
                schedule=schedule), len(R_sets), len(S_sets))
        np.testing.assert_array_equal(mask, ref_ops.lfvt_walk_join_mask(
            flat_ref, r_pad, r_sz, lo, hi, t, measure=measure, impl="jnp",
            schedule=schedule))
        got[schedule] = (pairs.numpy(), st)
    assert got["device"][1]["live_tiles"] < got["device"][1]["total_tiles"]
    np.testing.assert_array_equal(got["host"][0], got["device"][0])
    with pytest.raises(ValueError, match="unknown walk schedule"):
        port_ops.lfvt_walk_join_pairs_dispatch(
            flat, torch.tensor(r_pad), r_sz, lo, hi, t, schedule="planned")
