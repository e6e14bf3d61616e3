"""PyTorch port vs JAX package: ``repro_torch.join`` end to end.

The same ``SetCollection`` inputs go through ``repro.join`` and
``repro_torch.join(..., device="cpu")``; the pair sets must be identical
and so must the counters the algorithm defines (pair_count, live_tiles,
total_tiles, walk_steps, early_stops, regrows, r_blocks, output_bytes,
s_flat_bytes), for both LFVT methods x 4 measures x 4 thresholds x both
emit modes, at an ``r_block``/``row_tile`` small enough that several
blocks and tiles occur. Also: the regrow protocol, empty inputs, the
planner's ``JoinPlan``, the port's import hygiene, and every error the
port raises for what it does not run yet.
"""
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.core.config import global_config as ref_config
from repro.core.planner import build_plan as ref_build_plan
from repro_torch.core.config import global_config as port_config
from repro_torch.core.planner import PlannerError
from repro_torch.core.planner import build_plan as port_build_plan
from repro_torch.errors import DeviceUnavailableError, NotPortedError
from repro_torch.kernels import ops as port_ops

ROOT = pathlib.Path(__file__).resolve().parents[1]
MEASURES = ("jaccard", "cosine", "dice", "overlap")
THRESHOLDS = (0.5, 0.7, 0.9, 2 / 3)
COUNTERS = ("pair_count", "live_tiles", "total_tiles", "walk_steps",
            "early_stops", "regrows", "r_blocks", "output_bytes",
            "s_flat_bytes")
TUNING = dict(r_block=24, row_tile=8)


def sample_sets(seed=5, n_r=60, n_s=44, universe=90):
    """Zipf-skewed R; S shares a prefix of R verbatim and perturbs the
    rest, so every measure finds pairs."""
    rng = np.random.default_rng(seed)
    r = [np.unique(rng.integers(0, universe,
                                size=int(min(16, 1 + rng.zipf(1.4)))))
         for _ in range(n_r)]
    s = r[:n_s // 3] + [
        np.unique(np.concatenate([b, rng.integers(0, universe, 2)]))
        for b in r[n_s // 3:n_s]]
    return r, s


@pytest.fixture(scope="module")
def collections():
    r, s = sample_sets()
    return (repro.as_collection(r), repro.as_collection(s),
            repro_torch.as_collection(r), repro_torch.as_collection(s))


def assert_same_join(a, b, keys=COUNTERS):
    assert a.pairs == b.pairs
    for k in keys:
        assert (k in a.stats.raw) == (k in b.stats.raw), k
        if k in a.stats.raw:
            assert a.stats.raw[k] == b.stats.raw[k], k


@pytest.mark.parametrize("emit", ["pairs", "mask"])
@pytest.mark.parametrize("t", THRESHOLDS)
@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("method", ["lfvt", "lfvt_ref"])
def test_join_matches_reference(collections, method, measure, t, emit):
    R, S, Rt, St = collections
    a = repro.join(R, S, t, method=method, measure=measure, emit=emit,
                   **TUNING)
    b = repro_torch.join(Rt, St, t, method=method, measure=measure,
                         emit=emit, device="cpu", **TUNING)
    assert_same_join(a, b)
    assert b.stats["device"] == "cpu"
    if emit == "mask":
        np.testing.assert_array_equal(b.mask, a.mask)
    else:
        assert b.mask is None
    if method == "lfvt":
        assert b.stats.raw["r_blocks"] > 1
        assert b.stats.raw["total_tiles"] > b.stats.raw["r_blocks"]


def test_join_has_pairs_at_every_measure(collections):
    R, S, Rt, St = collections
    for measure in MEASURES:
        assert repro_torch.join(Rt, St, 0.7, method="lfvt", measure=measure,
                                device="cpu").pairs, measure


@pytest.mark.parametrize("method", ["lfvt", "lfvt_ref"])
def test_tiny_pair_capacity_regrows(collections, monkeypatch, method):
    R, S, Rt, St = collections
    for cfg in (ref_config, port_config):  # capacity 1, not one grain
        monkeypatch.setattr(cfg, "pair_cap_grain", 1)
    a = repro.join(R, S, 0.5, method=method, pair_capacity=1, **TUNING)
    b = repro_torch.join(Rt, St, 0.5, method=method, pair_capacity=1,
                         device="cpu", **TUNING)
    assert_same_join(a, b)
    assert b.stats.raw["regrows"] >= 1


@pytest.mark.parametrize("side", ["R", "S", "both"])
def test_empty_inputs(side):
    r, s = sample_sets(n_r=10, n_s=9)
    r = [] if side in ("R", "both") else r
    s = [] if side in ("S", "both") else s
    for method in ("lfvt", "lfvt_ref"):
        a = repro.join(repro.as_collection(r), repro.as_collection(s), 0.5,
                       method=method)
        b = repro_torch.join(repro_torch.as_collection(r),
                             repro_torch.as_collection(s), 0.5,
                             method=method, device="cpu")
        assert b.pairs == a.pairs == frozenset()
        assert_same_join(a, b, ("pair_count", "r_blocks", "output_bytes",
                                "regrows"))


def test_double_buffer_and_r_block_cache(collections):
    R, S, Rt, St = collections
    want = repro_torch.join(Rt, St, 0.5, method="lfvt", device="cpu",
                            double_buffer=False, **TUNING)
    st: dict = {}
    got = repro_torch.join(Rt, St, 0.5, method="lfvt", device="cpu",
                           stats=st, **TUNING)
    assert got.pairs == want.pairs and st["double_buffered"]
    assert st["r_rep_cache_hits"] == st["r_blocks"]  # second pass: cached
    assert st["s_rep_cache_hit"]


def _plan_inputs(universe):
    rng = np.random.default_rng(2)
    sets = [rng.integers(0, universe, size=int(rng.integers(3, 12)))
            for _ in range(40)]
    return sets, sets[::-1]


@pytest.mark.parametrize("universe", [256, 2 ** 21])
def test_auto_plan_matches_reference(monkeypatch, universe):
    """Same probe, same scores, same pick with the reference's
    calibration off (the port scores with the default coefficients)."""
    monkeypatch.setattr(ref_config, "planner_calibrate", False)
    r, s = _plan_inputs(universe)
    args = (0.5,)
    a = ref_build_plan(repro.as_collection(r), repro.as_collection(s), *args,
                       driver="device", method="auto")
    b = port_build_plan(repro_torch.as_collection(r),
                        repro_torch.as_collection(s), *args, method="auto")
    assert a.to_dict() == b.to_dict()
    if universe == 2 ** 21:
        # the lfvt pick runs end to end and equals the reference
        assert b.method == "lfvt"
        ra = repro.join(r, s, 0.5)
        rb = repro_torch.join(r, s, 0.5, device="cpu")
        assert rb.plan.to_dict() == ra.plan.to_dict()
        assert rb.pairs == ra.pairs
    else:
        assert b.method == "popcount"
        with pytest.raises(NotPortedError, match="'popcount'"):
            repro_torch.join(r, s, 0.5, device="cpu")


def test_port_never_loads_jax_or_repro():
    """A port join in a fresh interpreter leaves jax and repro unloaded,
    and no source line of the port imports either."""
    code = ("import sys; import numpy as np; import repro_torch\n"
            "r = repro_torch.join([np.arange(5), np.arange(3)], "
            "[np.arange(4)], 0.5, method='lfvt', device='cpu')\n"
            "assert r.pairs == {(0, 0), (1, 0)}, r.pairs\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "print('LOADED', bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout
    pat = re.compile(r"^\s*(import jax|from jax|import repro\b|"
                     r"from repro[ .])", re.M)
    for path in [*(ROOT / "src" / "repro_torch").rglob("*.py"),
                 ROOT / "chip_smoke.py"]:
        assert not pat.search(path.read_text()), path


def test_default_device_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailableError, match="device='cpu'"):
        repro_torch.join([[1, 2]], [[1, 2]], 0.5, method="lfvt")
    with pytest.raises(DeviceUnavailableError):
        repro_torch.cf_rs_join_device(repro_torch.as_collection([[1]]),
                                      repro_torch.as_collection([[1]]), 0.5,
                                      device="cuda")


@pytest.mark.parametrize("kwargs,match", [
    (dict(n_shards=2), "MapReduce"),
    (dict(mesh=object()), "MapReduce"),
    (dict(fault_plan=""), "fault_plan"),
    (dict(fault_plan="compact:transient"), "fault_plan"),
    (dict(checkpoint_dir="ckpt"), "checkpoint_dir"),
    (dict(method="popcount"), "'popcount'"),
    (dict(method="kernel_onehot"), "'kernel_onehot'"),
])
def test_not_ported_paths_raise(kwargs, match):
    r, s = sample_sets(n_r=8, n_s=6)
    with pytest.raises(NotPortedError, match=match):
        repro_torch.join(r, s, 0.5, device="cpu", **kwargs)
    assert issubclass(NotPortedError, ValueError)


def test_not_ported_kernel_paths_raise():
    R = repro_torch.as_collection(sample_sets(n_r=8, n_s=6)[0])
    flat = R.sort_by_size().flat_lfvt()
    r_pad = torch.from_numpy(R.padded()[0].copy())
    r_sz = R.sizes()
    lo, hi = np.zeros(len(R), np.int64), np.full(len(R), len(R), np.int64)
    with pytest.raises(NotPortedError, match="K6"):
        port_ops.lfvt_walk_join_pairs_dispatch(flat, r_pad, r_sz, lo, hi,
                                               0.5, schedule="device")


def test_planner_errors_match_reference():
    r, s = sample_sets(n_r=8, n_s=6)
    for kw in (dict(strategy="even"), dict(schedule="static"),
               dict(emit="dense"), dict(method="bogus"),
               dict(emit="mask", pair_capacity=4)):
        with pytest.raises(PlannerError) as got:
            repro_torch.join(r, s, 0.5, device="cpu", **kw)
        with pytest.raises(ValueError) as want:
            repro.join(r, s, 0.5, **kw)
        assert str(got.value) == str(want.value), kw
