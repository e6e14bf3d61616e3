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
