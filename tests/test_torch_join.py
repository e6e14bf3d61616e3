"""PyTorch port vs JAX package: ``repro_torch.join`` end to end.

The same ``SetCollection`` inputs go through ``repro.join`` and
``repro_torch.join(..., device="cpu")``; the pair sets must be identical
and so must the counters the algorithm defines (pair_count, live_tiles,
total_tiles, walk_steps, early_stops, regrows, r_blocks, output_bytes,
s_flat_bytes), for both LFVT methods x 4 measures x 4 thresholds x both
emit modes, at an ``r_block``/``row_tile`` small enough that several
blocks and tiles occur; and for the popcount and one-hot families
(``popcount``, ``onehot``, ``kernel_bitmap``, ``kernel_onehot``) x 4
measures x 2 thresholds x both emits, where the whole stats mapping and
the plan must be equal. Also: the regrow protocol, empty inputs, the
planner's ``JoinPlan`` and ``method="auto"``, the driver's default
method, the port's import hygiene, the paths that raised until they were
ported (the MapReduce loop path, the resilience kwargs, the dedup
pipeline's batch filter), which now equal the reference, and the error
the port still raises for the multi-device path.
"""
import functools
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
from repro_torch.errors import DeviceUnavailableError, MeshTypeError

ROOT = pathlib.Path(__file__).resolve().parents[1]
MEASURES = ("jaccard", "cosine", "dice", "overlap")
THRESHOLDS = (0.5, 0.7, 0.9, 2 / 3)
COUNTERS = ("pair_count", "live_tiles", "total_tiles", "walk_steps",
            "early_stops", "regrows", "r_blocks", "output_bytes",
            "s_flat_bytes")
TUNING = dict(r_block=24, row_tile=8)
BITMAP_METHODS = ("popcount", "onehot", "kernel_bitmap", "kernel_onehot")
# stats that say what a cache held before the call, not what the join did
CACHE_STATS = ("device", "s_rep_cache_hit", "r_rep_cache_hits")


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


@pytest.mark.parametrize("emit", ["pairs", "mask"])
@pytest.mark.parametrize("t", [0.5, 2 / 3])
@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("method", BITMAP_METHODS)
def test_bitmap_methods_match_reference(collections, method, measure, t,
                                        emit):
    R, S, Rt, St = collections
    a = repro.join(R, S, t, method=method, measure=measure, emit=emit,
                   r_block=TUNING["r_block"])
    b = repro_torch.join(Rt, St, t, method=method, measure=measure,
                         emit=emit, device="cpu", r_block=TUNING["r_block"])
    assert b.pairs == a.pairs and b.pairs
    assert b.plan.to_dict() == a.plan.to_dict()
    want = {k: v for k, v in a.stats.raw.items() if k not in CACHE_STATS}
    got = {k: v for k, v in b.stats.raw.items() if k not in CACHE_STATS}
    assert got == want
    assert b.stats.raw["r_blocks"] > 1
    # live_tiles/total_tiles only on the kernels' live-tile pair path
    assert ("live_tiles" in got) == (method.startswith("kernel_")
                                     and emit == "pairs")
    if emit == "mask":
        np.testing.assert_array_equal(b.mask, a.mask)


def test_join_has_pairs_at_every_measure(collections):
    R, S, Rt, St = collections
    for measure in MEASURES:
        assert repro_torch.join(Rt, St, 0.7, method="lfvt", measure=measure,
                                device="cpu").pairs, measure


@pytest.mark.parametrize("method", ["lfvt", "lfvt_ref", *BITMAP_METHODS])
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
    for method in ("lfvt", "lfvt_ref", *BITMAP_METHODS):
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
    """Same probe, same scores, same pick with calibration off in both
    packages (both score with the default coefficients)."""
    for cfg in (ref_config, port_config):
        monkeypatch.setattr(cfg, "planner_calibrate", False)
    r, s = _plan_inputs(universe)
    args = (0.5,)
    a = ref_build_plan(repro.as_collection(r), repro.as_collection(s), *args,
                       driver="device", method="auto")
    b = port_build_plan(repro_torch.as_collection(r),
                        repro_torch.as_collection(s), *args, method="auto")
    assert a.to_dict() == b.to_dict()
    # the pick (lfvt on the large universe, popcount on the small one)
    # runs end to end and equals the reference
    assert b.method == ("lfvt" if universe == 2 ** 21 else "popcount")
    ra = repro.join(r, s, 0.5)
    rb = repro_torch.join(r, s, 0.5, device="cpu")
    assert rb.plan.to_dict() == ra.plan.to_dict()
    assert rb.plan.method == b.method and rb.plan.decided == "cost_model"
    assert rb.pairs == ra.pairs and rb.pairs


def test_driver_default_method_is_popcount(collections):
    """``cf_rs_join_device`` with no method runs popcount, as the
    reference's driver does, and says the pick was forced."""
    R, S, Rt, St = collections
    st: dict = {}
    want: dict = {}
    got = repro_torch.cf_rs_join_device(Rt, St, 0.5, device="cpu", stats=st)
    assert st["method"] == "popcount"
    assert st["plan"]["decided"] == "forced"
    from repro.core.tile_join import cf_rs_join_device as ref_driver
    assert got == ref_driver(R, S, 0.5, stats=want)
    assert st["plan"] == want["plan"]


@pytest.mark.parametrize("method", ["popcount", "kernel_onehot", "lfvt"])
@pytest.mark.parametrize("emit", ["pairs", "mask"])
def test_driver_ids_are_the_pair_set(collections, method, emit):
    """``cf_rs_join_device_ids`` gives the driver's pairs as two int64
    arrays, one entry per pair, with the same stats."""
    from repro_torch.core.tile_join import cf_rs_join_device_ids
    _, _, Rt, St = collections
    st_set: dict = {}
    st_ids: dict = {}
    want = repro_torch.cf_rs_join_device(Rt, St, 0.5, method=method,
                                         emit=emit, device="cpu",
                                         stats=st_set)
    r_ids, s_ids = cf_rs_join_device_ids(Rt, St, 0.5, method=method,
                                         emit=emit, device="cpu",
                                         stats=st_ids)
    assert r_ids.dtype == s_ids.dtype == np.int64
    assert len(r_ids) == len(s_ids) == len(want) > 0
    assert set(zip(r_ids.tolist(), s_ids.tolist())) == want
    assert ({k: v for k, v in st_ids.items() if k not in CACHE_STATS}
            == {k: v for k, v in st_set.items() if k not in CACHE_STATS})


def test_port_never_loads_jax_or_repro():
    """A port join, a served request, MapReduce joins, a managed join
    (fault plan and checkpoint, run twice) and a few generated tokens of
    a smoke LLM (both attention paths) in a fresh interpreter leave jax,
    repro and ml_dtypes unloaded, and no source line of the port imports
    any of them."""
    code = ("import sys; import numpy as np; import repro_torch\n"
            "for m in ('lfvt', 'popcount', 'onehot', 'kernel_bitmap', "
            "'kernel_onehot'):\n"
            "    r = repro_torch.join([np.arange(5), np.arange(3)], "
            "[np.arange(4)], 0.5, method=m, device='cpu')\n"
            "    assert r.pairs == {(0, 0), (1, 0)}, (m, r.pairs)\n"
            "S = repro_torch.SetCollection.from_ragged([np.arange(4)])\n"
            "for sch in ('host', 'device'):\n"
            "    e = repro_torch.DedupServeEngine(S, threshold=0.5, "
            "device='cpu', schedule=sch)\n"
            "    e.submit(np.arange(5))\n"
            "    assert e.drain()[0].matches == (0,), sch\n"
            "import tempfile\n"
            "R = repro_torch.as_collection([np.arange(5), np.arange(3)])\n"
            "for m in ('lfvt', 'auto', 'kernel_bitmap'):\n"
            "    assert repro_torch.mr_cf_rs_join(R, S, 0.5, 2, method=m, "
            "device='cpu') == {(0, 0), (1, 0)}, m\n"
            "d = tempfile.mkdtemp()\n"
            "for _ in range(2):\n"
            "    st = {}\n"
            "    r = repro_torch.join(R, S, 0.5, method='lfvt', device='cpu', "
            "stats=st, fault_plan='compact:transient', checkpoint_dir=d)\n"
            "    assert r.pairs == {(0, 0), (1, 0)} and st['retries'] + "
            "st['tasks_resumed'] >= 1, st\n"
            "import dataclasses, torch\n"
            "from repro_torch.models.params import init_params\n"
            "for impl in ('flash', 'jnp'):\n"
            "    m = repro_torch.build_model(dataclasses.replace("
            "repro_torch.get_config('qwen2-1.5b', smoke=True), "
            "attn_impl=impl))\n"
            "    p = init_params(m.param_specs(), "
            "torch.Generator().manual_seed(0), device='cpu')\n"
            "    out = repro_torch.ServeEngine(m, p, max_seq_len=16)"
            ".generate(np.zeros((2, 5), np.int32), 3)\n"
            "    assert out.shape == (2, 3), out.shape\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.') or m == 'ml_dtypes')\n"
            "print('LOADED', bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout
    pat = re.compile(r"^\s*(import jax|from jax|import repro\b|"
                     r"from repro[ .]|import ml_dtypes|from ml_dtypes)", re.M)
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
    (dict(mesh=object()), "launch.mesh.Mesh"),
    (dict(fault_plan=""), "fault_plan"),
    (dict(fault_plan="compact:transient"), "fault_plan"),
    (dict(checkpoint_dir="ckpt"), "checkpoint_dir"),
])
def test_not_ported_paths_raise(kwargs, match, tmp_path, monkeypatch):
    """``mesh=`` raised ``NotPortedError`` until the multi-device path
    was ported; it now takes the port's ``Mesh`` only, and any other
    object (a jax mesh, say) raises the named ``MeshTypeError`` (a
    ``TypeError``). The MapReduce loop path (``n_shards=``) and the
    resilience kwargs raised until they were ported: they now run and
    equal ``repro.join`` with the same kwargs (each package in a
    directory of its own, so that ``checkpoint_dir`` starts empty)."""
    r, s = sample_sets(n_r=8, n_s=6)
    if "mesh" in kwargs:
        with pytest.raises(MeshTypeError, match=match) as err:
            repro_torch.join(r, s, 0.5, device="cpu", **kwargs)
        assert "object" in str(err.value)
        assert issubclass(MeshTypeError, TypeError)
        return
    for cfg in (ref_config, port_config):
        monkeypatch.setattr(cfg, "planner_calibrate", False)
    for cfg in (ref_config, port_config):
        monkeypatch.setattr(cfg, "fault", "")
    out = {}
    for name, fn in (("ref", repro.join), ("port", functools.partial(
            repro_torch.join, device="cpu"))):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        out[name] = fn(r, s, 0.5, **kwargs)
    a, b = out["ref"], out["port"]
    assert b.pairs == a.pairs and b.pairs
    assert b.plan.to_dict() == a.plan.to_dict()
    want = {k: v for k, v in a.stats.raw.items() if k not in CACHE_STATS}
    got = {k: v for k, v in b.stats.raw.items() if k not in CACHE_STATS}
    assert got == want
    if "checkpoint_dir" in kwargs:
        assert sorted(os.listdir(tmp_path / "port" / "ckpt")) == sorted(
            os.listdir(tmp_path / "ref" / "ckpt"))


def test_not_ported_kernel_paths_raise(monkeypatch):
    """The dedup pipeline's static-corpus filter runs the MapReduce
    driver; it raised until the driver was ported, and now drops the
    reference's documents with the reference's stats."""
    from repro.data.pipeline import DedupPipeline as RefPipeline
    for cfg in (ref_config, port_config):
        monkeypatch.setattr(cfg, "planner_calibrate", False)
    sets = sample_sets(n_r=8, n_s=6)[0]
    docs = np.asarray([np.resize(x, 4) for x in sets] + [[1, 2, 3, 4]])
    ref = RefPipeline(repro.as_collection(sets), threshold=0.5)
    pipe = repro_torch.DedupPipeline(repro_torch.as_collection(sets),
                                     threshold=0.5, device="cpu")
    (want, st_a), (got, st_b) = ref.filter_batch(docs), pipe.filter_batch(
        docs)
    np.testing.assert_array_equal(got, want)
    assert st_b == st_a and st_b["n_dropped"] >= 1


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
