"""PyTorch port vs JAX package: the MapReduce driver's multi-device path.

The same sets go through ``repro.core.distributed`` on a 4-device JAX
mesh and through ``repro_torch.core.distributed`` on a 4-slot CPU mesh
(``make_host_mesh(4, device="cpu")``), and the pairs and every stat must
be equal (exact: the stats are integer counts and ratios of them):

  * ``_lfvt_bucket_arrays`` and ``entry_positions`` byte-equal;
  * the shard body ``_lfvt_local_mask`` against the reference's jnp one,
    called directly under both schedules: mask, ``walk_steps``,
    ``early_stops`` and live tiles;
  * whole mesh joins against the reference's mesh joins: ``lfvt`` under
    both emits, both schedules and both pads, the 4 measures (dice at
    exactly 2/3), inputs with window-dead row tiles; the stacked
    ``popcount``/``onehot``/``kernel_bitmap``/``kernel_onehot`` under
    both emits; managed runs under seeded fault plans at the
    ``shard_map``, ``device_upload``, ``compact``, ``regrow`` and
    ``flat_tables`` sites and the guardrail, resilience counters
    included; the front door and ``DedupPipeline``;
  * stacked ``emit="pairs"`` also against the reference's loop path at
    ``pad="global"`` and ``brute_force_join``.

The reference's mesh path needs two adjustments on jax 0.9, both made
here and neither in ``src/repro``: a shim that passes the reference's
``check_rep`` on to ``jax.shard_map`` as ``check_vma`` (False where it
passes none: its Pallas kernels give no ``vma``), and a mesh with
``AxisType.Auto`` axes (``jax.make_mesh`` now defaults to explicit axes,
under which its pairs gather raises ``ShardingTypeError``). It runs in a
subprocess with 4 forced host devices; the port runs in this process.
"""
import functools
import importlib
import os
import pathlib
import pickle
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.core import distributed as ref_dist
from repro.core.config import global_config as ref_config
from repro.core.join import brute_force_join
from repro.core.lfvt_flat import entry_positions as ref_entry_positions
from repro_torch.core import distributed as port_dist
from repro_torch.core.config import global_config as port_config
from repro_torch.core.lfvt_flat import entry_positions as port_entry_positions
from repro_torch.errors import DeviceUnavailableError, MeshTypeError
from repro_torch.launch.mesh import Mesh, make_host_mesh
from tests._mr_cases import MEASURES, assert_same_stats, both, sample_sets

ROOT = pathlib.Path(__file__).resolve().parent.parent
N = 4                      # mesh slots = shards
MR_T = {"jaccard": 0.5, "cosine": 0.7, "dice": 2 / 3, "overlap": 0.9}
STACKED = ("popcount", "onehot", "kernel_bitmap", "kernel_onehot")


def mesh_sets():
    """``sample_sets`` plus 80 oversized R rows (|r| = 40 > 2 max|s|,
    their elements present in S). Under jaccard, cosine and dice their
    windows are empty: load-aware routing drops them, while ``hash``
    routing sends 20 to each shard, where they fill whole dead row tiles
    that the planned schedule skips and the static one walks."""
    r, s = sample_sets()
    rng = np.random.default_rng(11)
    big = [np.sort(rng.choice(90, 40, replace=False)) for _ in range(80)]
    return r + big, s


# ---------------------------------------------------------------------- #
# the cases held against the reference's mesh path: id -> (entry, kwargs)
# ---------------------------------------------------------------------- #
def _lfvt_cases():
    out = {}
    for measure, pad, schedule, strategy in (
            ("jaccard", "bucket", "planned", "load_aware"),
            ("jaccard", "global", "static", "hash"),
            ("jaccard", "global", "planned", "hash"),
            ("cosine", "global", "planned", "load_aware"),
            ("dice", "bucket", "static", "load_aware"),
            ("dice", "bucket", "planned", "hash"),
            ("overlap", "bucket", "planned", "load_aware")):
        for emit in ("pairs", "mask"):
            out[f"lfvt-{measure}-{pad}-{schedule}-{strategy}-{emit}"] = (
                "mr", dict(t=MR_T[measure], method="lfvt", measure=measure,
                           pad=pad, schedule=schedule, strategy=strategy,
                           emit=emit))
    return out


CASES = {
    **_lfvt_cases(),
    **{f"stacked-{m}-{e}": ("mr", dict(t=0.5, method=m, emit=e))
       for m in STACKED for e in ("mask", "pairs")},
    "stacked-popcount-cosine-mask": ("mr", dict(
        t=0.7, method="popcount", measure="cosine", emit="mask")),
    # managed runs: seeded plans at every mesh fault site
    "fault-shard_map": ("mr", dict(t=0.5, method="lfvt",
                                   fault_plan="shard_map:transient")),
    "fault-device_upload": ("mr", dict(t=0.5, method="lfvt",
                                       fault_plan="device_upload:oom")),
    "fault-compact": ("mr", dict(t=0.5, method="lfvt",
                                 fault_plan="compact:transient:2")),
    "fault-regrow": ("mr", dict(t=0.5, method="lfvt", pair_capacity=1,
                                fault_plan="regrow:transient",
                                config={"pair_cap_grain": 1})),
    "fault-flat_tables": ("mr", dict(t=0.5, method="lfvt",
                                     fault_plan="flat_tables:corrupt")),
    "fault-stacked-shard_map": ("mr", dict(
        t=0.5, method="popcount", fault_plan="shard_map:persistent")),
    "fault-none-mask": ("mr", dict(t=2 / 3, method="lfvt", measure="dice",
                                   emit="mask", fault_plan="")),
    # a bucket over the guardrail budget starts at the loop rung
    "guardrail": ("mr", dict(t=0.5, method="lfvt", fault_plan="",
                             config={"vmem_budget": 1024})),
    # the front door (n_shards from the mesh) and the dedup pipeline
    "join-lfvt": ("join", dict(t=0.5, method="lfvt")),
    "join-auto": ("join", dict(t=0.5)),
    "pipeline-lfvt": ("pipeline", dict(t=0.5, method="lfvt")),
}


def run_case(entry, kw, mesh, R, S):
    """One case through one package (``repro`` or ``repro_torch``
    collections pick the package) -> (sorted pairs, stats)."""
    kw = dict(kw)
    t = kw.pop("t")
    pkg = repro_torch if isinstance(R, repro_torch.SetCollection) else repro
    st: dict = {}
    if entry == "join":
        res = pkg.join(R, S, t, mesh=mesh, stats=st, **kw)
        return sorted(res.pairs), st
    if entry == "pipeline":
        docs = np.asarray([np.resize(x, 6) for x in R.sets[:30]])
        pipeline = importlib.import_module(pkg.__name__ + ".data.pipeline")
        pipe = pipeline.DedupPipeline(S, threshold=t, n_shards=N, mesh=mesh,
                                      **kw)
        kept, st = pipe.filter_batch(docs)
        return kept.tolist(), st
    dist = port_dist if pkg is repro_torch else ref_dist
    return sorted(dist.mr_cf_rs_join(R, S, t, N, mesh=mesh, stats=st,
                                     **kw)), st


def reference_results(out_path: str) -> None:
    """The reference's side of every case, on a 4-device JAX mesh (run
    in a subprocess whose XLA_FLAGS force 4 host devices) -> a pickle of
    {case id: (pairs, stats) or the exception's repr}."""
    import jax

    orig = ref_dist.shard_map

    @functools.wraps(orig)
    def shim(f, *args, check_rep=False, **kw):
        return orig(f, *args, check_vma=check_rep, **kw)

    ref_dist.shard_map = shim
    mesh = jax.make_mesh((N,), ("data",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    R, S = (repro.as_collection(x) for x in mesh_sets())
    out = {}
    for cid, (entry, kw) in CASES.items():
        kw = dict(kw)
        saved = ref_config.snapshot()
        for name, val in kw.pop("config", {}).items():
            setattr(ref_config, name, val)
        try:
            out[cid] = run_case(entry, kw, mesh, R, S)
        except Exception as e:  # recorded; the test names it
            out[cid] = repr(e)
        finally:
            ref_config.restore(saved)
    with open(out_path, "wb") as fh:
        pickle.dump(out, fh)


_SCRIPT = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={n}"
os.environ["REPRO_FAULT"] = ""
from tests.test_torch_mesh import reference_results
reference_results({out!r})
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh") / "reference.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu", REPRO_FAULT="",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT.format(n=N, out=str(out))],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out, "rb") as fh:
        return pickle.load(fh)


@pytest.fixture(scope="module")
def port_sets():
    return tuple(repro_torch.as_collection(x) for x in mesh_sets())


@pytest.fixture
def clean_config(monkeypatch):
    """No REPRO_FAULT plan from the environment."""
    for cfg in (ref_config, port_config):
        monkeypatch.setattr(cfg, "fault", "")


def assert_same_mesh_stats(a: dict, b: dict) -> None:
    assert_same_stats(a, b)
    for k in ("mesh_devices", "walk_schedule", "flat_pad_waste"):
        assert (k in a) == (k in b) and a.get(k) == b.get(k), k


@pytest.mark.parametrize("cid", list(CASES))
def test_mesh_join_matches_reference(cid, reference, port_sets,
                                     clean_config, monkeypatch):
    want = reference[cid]
    assert not isinstance(want, str), f"the reference raised: {want}"
    entry, kw = CASES[cid]
    kw = dict(kw)
    for name, val in kw.pop("config", {}).items():
        # the reference's vmem_budget is the port's guardrail_budget
        monkeypatch.setattr(port_config, {"vmem_budget": "guardrail_budget"}
                            .get(name, name), val)
    got = run_case(entry, kw, make_host_mesh(N, device="cpu"), *port_sets)
    assert got[0] == want[0]
    if entry == "pipeline":
        assert got[1]["n_dropped"] == want[1]["n_dropped"] > 0
    assert_same_mesh_stats(want[1], got[1])
    st = got[1]
    if cid.startswith("lfvt-"):
        assert st["mesh_devices"] == N and st["walk_steps"] > 0
        if st["walk_schedule"] == "static":
            assert st["live_tiles"] == st["total_tiles"]
        elif kw["strategy"] == "hash":  # the oversized rows' dead tiles
            assert st["live_tiles"] < st["total_tiles"]
    if cid.startswith("fault-") and kw.get("fault_plan"):
        assert st["faults_injected"] >= 1
    if cid == "guardrail":
        assert all(d.endswith(":mesh->loop(guardrail)")
                   for d in st["degradations"]) and st["degradations"]


@pytest.mark.parametrize("method", STACKED)
def test_stacked_pairs_match_loop_and_oracle(method, port_sets, clean_config):
    """Stacked ``emit="pairs"`` on the mesh against the reference's loop
    path at ``pad="global"`` and the brute-force oracle; with the dense
    popcount shards (``popcount``, ``onehot``) every stat equals the
    loop path's too (the same block and capacity protocol)."""
    R, S = (repro.as_collection(x) for x in mesh_sets())
    a, b = {}, {}
    want = ref_dist.mr_cf_rs_join(R, S, 0.5, N, method=method, pad="global",
                                  stats=a)
    got = port_dist.mr_cf_rs_join(*port_sets, 0.5, N, method=method,
                                  pad="global", stats=b,
                                  mesh=make_host_mesh(N, device="cpu"))
    assert got == want == brute_force_join(R, S, 0.5)
    if method in ("popcount", "onehot"):
        assert_same_stats(a, b)
    assert b["pad"] == "global" and b["n_buckets"] == 1


@pytest.mark.parametrize("method", STACKED)
def test_stacked_regrow_reruns_compaction_only(method, port_sets,
                                               clean_config, monkeypatch):
    """On the mesh a regrow keeps the stacked masks: each shard's join
    runs once, as the mesh lfvt walk does, and only the compaction runs
    again at the grown capacity."""
    calls = []
    join = port_dist.local_join_mask

    def counted(*args, **kw):
        calls.append(args[-2])
        return join(*args, **kw)

    monkeypatch.setattr(port_dist, "local_join_mask", counted)
    monkeypatch.setattr(port_config, "pair_cap_grain", 1)
    st: dict = {}
    got = port_dist.mr_cf_rs_join(*port_sets, 0.5, N, method=method,
                                  pad="global", pair_capacity=1, stats=st,
                                  mesh=make_host_mesh(N, device="cpu"))
    R, S = (repro.as_collection(x) for x in mesh_sets())
    assert got == brute_force_join(R, S, 0.5)
    assert st["regrows"] == 1 and st["n_buckets"] == 1
    assert calls == [method] * N


# ---------------------------------------------------------------------- #
# the shard body and its operands, in process
# ---------------------------------------------------------------------- #
def _shards(dist, R, S, t, measure):
    """The driver's per-shard preamble: (shard id, FlatLFVT, size-sorted
    R rows, max|r|) for every shard with rows on both sides."""
    part = dist.load_aware_partition(R, S, t, N, measure=measure)
    s_rows, r_rows, _ = dist.route(R, S, part)
    sizes = R.sizes()
    out = []
    for k in range(N):
        rs, ss = r_rows[k], s_rows[k]
        if len(rs) and len(ss):
            rs = rs[np.argsort(-sizes[rs], kind="stable")]
            sub = type(S)([S.sets[int(j)] for j in ss], S.universe,
                          S.ids[ss].astype(np.int32))
            out.append((k, sub.flat_lfvt(), rs,
                        max(int(sizes[rs].max(initial=0)), 1)))
    return out


def _bucket_arrays(dist, R, S, t, measure, single):
    shards = _shards(dist, R, S, t, measure)
    buckets = [[s] for s in shards] if single else [shards]
    tm = 16
    r_pad, _ = R.padded()
    out = []
    for bucket in buckets:
        caps = (-(-max(len(rs) for _, _, rs, _ in bucket) // tm) * tm,
                max(f.n_sets for _, f, _, _ in bucket),
                max(max(len(f.entry_elem), 1) for _, f, _, _ in bucket),
                max(max(len(f.seq_row), 1) for _, f, _, _ in bucket),
                max(f.max_seq_len for _, f, _, _ in bucket))
        lr = min(max(lr for *_, lr in bucket), r_pad.shape[1])
        out.append((caps, dist._lfvt_bucket_arrays(
            bucket, caps, lr, r_pad, R.sizes(), R.ids, t, measure)))
    return out


@pytest.mark.parametrize("single", [False, True], ids=["global", "single"])
@pytest.mark.parametrize("measure", MEASURES)
def test_bucket_arrays_byte_equal(measure, single):
    R, S, Rt, St = both(*mesh_sets())
    t = MR_T[measure]
    ref = _bucket_arrays(ref_dist, R, S, t, measure, single)
    port = _bucket_arrays(port_dist, Rt, St, t, measure, single)
    assert len(ref) == len(port) >= 1
    for (ca, (aa, ra, sa, ua, la)), (cb, (ab, rb, sb, ub, lb)) in zip(
            ref, port):
        assert ca == cb and la == lb
        for x, y in zip(aa + (ra, sa, ua), ab + (rb, sb, ub)):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert x.tobytes() == y.tobytes()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_entry_positions_byte_equal(seed):
    r, s = sample_sets(seed=seed)
    _, S, _, St = both(r, s)
    a = ref_entry_positions(S.sort_by_size().flat_lfvt())
    b = port_entry_positions(St.sort_by_size().flat_lfvt())
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("schedule", ["planned", "static"])
@pytest.mark.parametrize("measure", MEASURES)
def test_local_mask_matches_reference(measure, schedule):
    """The port's shard body against the reference's jnp one, shard by
    shard of the global bucket: mask, walk_steps, early_stops, live."""
    R, S, Rt, St = both(*mesh_sets())
    t = MR_T[measure]
    (caps, (arrays, *_)), = _bucket_arrays(ref_dist, R, S, t, measure, False)
    kw = dict(t=t, measure=measure, max_steps=caps[4], tm=16,
              schedule=schedule)
    dead = 0
    for lk in range(arrays[0].shape[0]):
        want = ref_dist._lfvt_local_mask(
            *(jnp.asarray(a[lk]) for a in arrays), **kw)
        got = port_dist._lfvt_local_mask(
            *(torch.from_numpy(a[lk]) for a in arrays), **kw)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        assert [int(x) for x in got[1:]] == [int(x) for x in want[1:]]
        dead += caps[0] // 16 - int(got[3])
    if schedule == "planned" and measure != "overlap":
        assert dead > 0  # the oversized rows' tiles are skipped


# ---------------------------------------------------------------------- #
# the mesh object
# ---------------------------------------------------------------------- #
def test_host_mesh_and_checks(port_sets):
    R, S = port_sets
    mesh = make_host_mesh(3, device="cpu")
    assert mesh.shape == {"data": 3} and mesh.axis_names == ("data",)
    assert mesh.devices == (torch.device("cpu"),) * 3
    assert make_host_mesh(device="cpu").shape["data"] == 1
    assert Mesh(("cpu", "cpu")) == make_host_mesh(2, device="cpu")
    two = Mesh(("cpu",), axis_names=("data", "model"))
    assert two.shape == {"data": 1, "model": 1} and two.size == 1
    with pytest.raises(ValueError, match="n_shards=4"):
        port_dist.mr_cf_rs_join(R, S, 0.5, 4, method="lfvt", mesh=mesh)
    with pytest.raises(ValueError, match="'model' axis"):
        repro_torch.join(R, S, 0.5, method="lfvt", mesh=mesh, axis="model")
    with pytest.raises(MeshTypeError, match="jax"):
        import jax
        repro_torch.join(R, S, 0.5, mesh=jax.make_mesh((1,), ("data",)))
    if not torch.cuda.is_available():
        with pytest.raises(DeviceUnavailableError):
            make_host_mesh(2)
        with pytest.raises(DeviceUnavailableError):
            Mesh(("cuda",))


@pytest.mark.parametrize("kw", [
    dict(method="lfvt_ref"), dict(method="lfvt", pad="diagonal"),
    dict(method="popcount", pad="bucket"),
    dict(method="lfvt", schedule="device"),
])
def test_mesh_lattice_errors_match_reference(kw, port_sets):
    """The mesh path's named errors, with the reference's texts."""
    R, S = (repro.as_collection(x) for x in mesh_sets())

    class OneAxis:  # enough of a mesh for the reference's checks
        shape = {"data": N}

    with pytest.raises(ValueError) as want:
        ref_dist.mr_cf_rs_join(R, S, 0.5, N, mesh=OneAxis(), **kw)
    with pytest.raises(ValueError) as got:
        port_dist.mr_cf_rs_join(*port_sets, 0.5, N,
                                mesh=make_host_mesh(N, device="cpu"), **kw)
    assert str(got.value) == str(want.value)
