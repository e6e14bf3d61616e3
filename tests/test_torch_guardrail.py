"""PyTorch port vs JAX package: the managed paths' memory guardrail.

The port's budget (``guardrail_budget``) defaults to a share of the
total memory of the device a task runs on, resolved at each call
(``resolve_guardrail_budget``); an explicit value, from code or
``REPRO_GUARDRAIL_BUDGET``, wins. At a budget pinned equal in both
packages (the reference's ``vmem_budget``), the split spans, their task
ids (read back from the checkpoint files), ``guardrail_splits``, the
degradations, every resilience counter and the pairs equal the
reference's on the single-device driver, the MapReduce loop path
(``lfvt`` and ``auto``) and the mesh path (the reference on 4 forced
host devices in a subprocess, as ``test_torch_mesh.py`` runs it). A
guardrail-split shard encodes its S once per call, with the
reference's ``shard_block_bytes`` and injected corruptions; a join
killed at its 2nd checkpoint write under a split resumes.
"""
import functools
import os
import pathlib
import pickle
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.core import distributed as ref_dist
from repro.core.config import global_config as ref_config
from repro.core.tile_join import cf_rs_join_device as ref_device
from repro_torch.core import config as port_cfg
from repro_torch.core import distributed as port_dist
from repro_torch.core import lfvt_flat as port_flat
from repro_torch.core.config import global_config as port_config
from repro_torch.core.join import brute_force_join
from repro_torch.core.partition import load_aware_partition, route
from repro_torch.core.tile_join import cf_rs_join_device as port_device
from repro_torch.launch.mesh import make_host_mesh
from tests._mr_cases import assert_same_stats, both, sample_sets
from tests.test_torch_mesh import N, assert_same_mesh_stats, mesh_sets

ROOT = pathlib.Path(__file__).resolve().parent.parent
T = 0.5
#: pinned budgets: every task split / over budget, some, none (1 << 20)
BUDGETS = (256, 2048, 1 << 20)


@pytest.fixture(autouse=True)
def managed_env(monkeypatch):
    """No REPRO_FAULT plan from the environment; both packages plan
    uncalibrated; the port's budget unpinned."""
    for cfg in (ref_config, port_config):
        monkeypatch.setattr(cfg, "fault", "")
        monkeypatch.setattr(cfg, "planner_calibrate", False)
    monkeypatch.setattr(port_config, "guardrail_budget", None)


def pin(monkeypatch, budget: int) -> None:
    monkeypatch.setattr(ref_config, "vmem_budget", budget)
    monkeypatch.setattr(port_config, "guardrail_budget", budget)


def task_ids(d) -> list:
    """The task ids of a checkpoint directory (each ``task_*.npz`` holds
    its own)."""
    out = []
    for f in sorted(pathlib.Path(d).glob("task_*.npz")):
        with np.load(f) as z:
            out.append(str(z["task"]))
    return sorted(out)


# ---------------------------------------------------------------------- #
# the budget
# ---------------------------------------------------------------------- #
def test_budget_is_a_share_of_the_hosts_total_memory():
    total = os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    want = int(total * port_cfg.GUARDRAIL_SHARE)
    assert port_cfg.GUARDRAIL_SHARE == 0.5
    assert port_cfg.resolve_guardrail_budget("cpu") == want
    assert port_cfg.resolve_guardrail_budget(torch.device("cpu")) == want


def test_budget_is_a_share_of_the_cards_total_memory(monkeypatch):
    seen = []

    def props(device):
        seen.append(device)
        return types.SimpleNamespace(total_memory=85_045_870_592,
                                     free_memory=1 << 30)

    monkeypatch.setattr(torch.cuda, "get_device_properties", props)
    dev = torch.device("cuda", 0)
    got = [port_cfg.resolve_guardrail_budget(dev) for _ in range(3)]
    assert got == [42_522_935_296] * 3 and seen == [dev] * 3


def test_explicit_budget_wins(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: types.SimpleNamespace(total_memory=1 << 40))
    monkeypatch.setattr(port_config, "guardrail_budget", 4096)
    for dev in ("cpu", torch.device("cuda", 0)):
        assert port_cfg.resolve_guardrail_budget(dev) == 4096
    monkeypatch.setenv("REPRO_GUARDRAIL_BUDGET", "65536")
    cfg = port_cfg.GlobalConfig()
    assert cfg.guardrail_budget == 65536
    assert type(cfg.guardrail_budget) is int


@pytest.mark.parametrize("raw", ["abc", "1.5", "", "16MiB"])
def test_env_budget_must_be_an_int(raw, monkeypatch):
    monkeypatch.setenv("REPRO_GUARDRAIL_BUDGET", raw)
    with pytest.raises(port_cfg.ConfigError,
                       match=r"REPRO_GUARDRAIL_BUDGET=.* is not a valid int"):
        port_cfg.GlobalConfig()


def test_drivers_resolve_the_default_at_each_call(monkeypatch, tmp_path):
    """With no pinned budget the drivers split as the reference does at
    the resolved figure: a host of 4 KiB (2 KiB of budget) here."""
    real = os.sysconf
    monkeypatch.setattr(os, "sysconf", lambda name: {
        "SC_PHYS_PAGES": 1, "SC_PAGE_SIZE": 4096}.get(name) or real(name))
    monkeypatch.setattr(ref_config, "vmem_budget", 2048)
    R, S, RT, ST = both(*sample_sets())
    a: dict = {}
    b: dict = {}
    want = ref_dist.mr_cf_rs_join(R, S, T, 4, method="lfvt", stats=a,
                                  checkpoint_dir=str(tmp_path / "r"))
    got = port_dist.mr_cf_rs_join(RT, ST, T, 4, method="lfvt", stats=b,
                                  checkpoint_dir=str(tmp_path / "p"),
                                  device="cpu")
    assert got == want and b["guardrail_splits"] == a["guardrail_splits"] > 0
    assert task_ids(tmp_path / "p") == task_ids(tmp_path / "r")


# ---------------------------------------------------------------------- #
# parity at a pinned budget: single device, loop path
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("budget", BUDGETS)
@pytest.mark.parametrize("method", ["lfvt", "popcount"])
def test_device_driver_splits_match_reference(method, budget, monkeypatch,
                                              tmp_path):
    pin(monkeypatch, budget)
    R, S, RT, ST = both(*sample_sets())
    a: dict = {}
    b: dict = {}
    want = ref_device(R, S, T, method=method, r_block=16, stats=a,
                      checkpoint_dir=str(tmp_path / "r"))
    got = port_device(RT, ST, T, method=method, r_block=16, stats=b,
                      checkpoint_dir=str(tmp_path / "p"), device="cpu")
    assert got == want == brute_force_join(RT, ST, T)
    for k in ("retries", "degradations", "faults_injected",
              "guardrail_splits", "tasks_resumed", "backoff_total",
              "pair_count", "r_blocks"):
        assert b[k] == a[k], k
    assert (b["guardrail_splits"] > 0) == (budget < 1 << 20)
    assert task_ids(tmp_path / "p") == task_ids(tmp_path / "r")


def mixed_sets():
    """Many tiny sets over a small universe plus a block of large sets
    over a large one (``test_torch_mr_paths.py``'s): the per-shard
    ``auto`` plan mixes popcount and lfvt shards on the loop path."""
    rng = np.random.default_rng(3)
    small = [np.unique(rng.integers(0, 64, size=int(rng.integers(2, 5))))
             for _ in range(80)]
    large = [np.unique(rng.integers(0, 1 << 18, size=60)) for _ in range(12)]
    s = small[::-1] + [np.unique(np.concatenate([x[:-2], x[:2] + 1]))
                       for x in large]
    return small + large, s


@pytest.mark.parametrize("budget", BUDGETS)
@pytest.mark.parametrize("method", ["lfvt", "auto"])
def test_loop_path_splits_match_reference(method, budget, monkeypatch,
                                          tmp_path):
    pin(monkeypatch, budget)
    R, S, RT, ST = both(*(sample_sets() if method == "lfvt"
                          else mixed_sets()))
    a: dict = {}
    b: dict = {}
    want = ref_dist.mr_cf_rs_join(R, S, T, 4, method=method, stats=a,
                                  checkpoint_dir=str(tmp_path / "r"))
    got = port_dist.mr_cf_rs_join(RT, ST, T, 4, method=method, stats=b,
                                  checkpoint_dir=str(tmp_path / "p"),
                                  device="cpu")
    assert got == want
    assert_same_stats(a, b)
    assert (b["guardrail_splits"] > 0) == (budget < 1 << 20)
    assert task_ids(tmp_path / "p") == task_ids(tmp_path / "r")
    if method == "auto":
        assert set(b["shard_methods"]) == {"popcount", "lfvt"}


# ---------------------------------------------------------------------- #
# one encode per shard
# ---------------------------------------------------------------------- #
def test_split_shard_encodes_its_s_once(monkeypatch, tmp_path):
    """At 256 B every shard splits into 3 or more spans; each shard's S
    is encoded once, while the spans' shipped bytes and the injected
    (and detected) table corruptions are the reference's."""
    pin(monkeypatch, 256)
    calls = []
    real = port_flat.encode

    def counting(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(port_flat, "encode", counting)
    R, S, RT, ST = both(*sample_sets())
    plan = "flat_tables:corrupt:2"
    a: dict = {}
    b: dict = {}
    want = ref_dist.mr_cf_rs_join(R, S, T, 4, method="lfvt", stats=a,
                                  fault_plan=plan,
                                  checkpoint_dir=str(tmp_path / "r"))
    got = port_dist.mr_cf_rs_join(RT, ST, T, 4, method="lfvt", stats=b,
                                  fault_plan=plan,
                                  checkpoint_dir=str(tmp_path / "p"),
                                  device="cpu")
    assert got == want
    assert_same_stats(a, b)
    assert b["faults_injected"] > 0 and b["retries"] > 0
    s_rows, r_rows, _ = route(RT, ST, load_aware_partition(RT, ST, T, 4))
    walked = [k for k in range(4) if len(r_rows[k]) and len(s_rows[k])]
    ids = task_ids(tmp_path / "p")
    spans = {k: sum(f"/shard={k}/span=" in i for i in ids) for k in walked}
    assert min(spans.values()) >= 3, spans
    assert len(calls) == len(walked) < sum(spans.values())


# ---------------------------------------------------------------------- #
# the mesh path, against the reference on 4 forced host devices
# ---------------------------------------------------------------------- #
def mesh_reference(out_path: str, ckpt_root: str) -> None:
    """The reference's mesh ``lfvt`` join at each of BUDGETS with a
    checkpoint directory (run in a subprocess whose XLA_FLAGS force 4
    host devices; the ``shard_map`` shim of ``test_torch_mesh.py``) ->
    a pickle of {budget: (pairs, stats, task ids)}."""
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
    for budget in BUDGETS:
        ref_config.vmem_budget = budget
        d = os.path.join(ckpt_root, f"ref-{budget}")
        st: dict = {}
        pairs = ref_dist.mr_cf_rs_join(R, S, T, N, mesh=mesh, method="lfvt",
                                       stats=st, checkpoint_dir=d)
        out[budget] = (sorted(pairs), st, task_ids(d))
    with open(out_path, "wb") as fh:
        pickle.dump(out, fh)


_MESH_SCRIPT = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={n}"
os.environ["REPRO_FAULT"] = ""
from tests.test_torch_guardrail import mesh_reference
mesh_reference({out!r}, {root!r})
"""


@pytest.fixture(scope="module")
def mesh_ref(tmp_path_factory):
    root = tmp_path_factory.mktemp("guardrail_mesh")
    out = root / "reference.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu", REPRO_FAULT="",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    proc = subprocess.run(
        [sys.executable, "-c",
         _MESH_SCRIPT.format(n=N, out=str(out), root=str(root))],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out, "rb") as fh:
        return pickle.load(fh)


@pytest.mark.parametrize("budget", BUDGETS)
def test_mesh_guardrail_matches_reference(budget, mesh_ref, monkeypatch,
                                          tmp_path):
    pin(monkeypatch, budget)
    want_pairs, want, want_ids = mesh_ref[budget]
    RT, ST = (repro_torch.as_collection(x) for x in mesh_sets())
    st: dict = {}
    got = port_dist.mr_cf_rs_join(RT, ST, T, N,
                                  mesh=make_host_mesh(N, device="cpu"),
                                  method="lfvt", stats=st,
                                  checkpoint_dir=str(tmp_path / "p"))
    assert sorted(got) == want_pairs
    assert_same_mesh_stats(want, st)
    assert task_ids(tmp_path / "p") == want_ids
    over = [d for d in st["degradations"]
            if d.endswith(":mesh->loop(guardrail)")]
    assert len(over) == {256: st["n_buckets"], 2048: 1, 1 << 20: 0}[budget]


# ---------------------------------------------------------------------- #
# kill at the 2nd checkpoint write under a split, then resume
# ---------------------------------------------------------------------- #
_KILL_SCRIPT = r"""
import os, pickle
import repro_torch
from repro_torch.core.join import brute_force_join

with open(os.environ["KILL_TEST_SETS"], "rb") as fh:
    R, S = (repro_torch.as_collection(x) for x in pickle.load(fh))
phase = os.environ["KILL_TEST_PHASE"]
st = {}
got = repro_torch.mr_cf_rs_join(
    R, S, 0.5, 4, method="lfvt", stats=st, device="cpu",
    checkpoint_dir=os.environ["KILL_TEST_CKPT"],
    fault_plan="checkpoint_write:kill:2" if phase == "kill" else None)
if phase == "kill":
    print("UNREACHABLE")            # SIGKILL fires before we get here
else:
    assert got == brute_force_join(R, S, 0.5), len(got)
    assert st["tasks_resumed"] >= 1 and st["guardrail_splits"] > 0, st
    print("RESUME_OK", st["tasks_resumed"], st["guardrail_splits"])
"""


def test_kill_and_resume_under_a_split(tmp_path):
    """The budget comes from REPRO_GUARDRAIL_BUDGET in both children, so
    the resumed run cuts its spans as the killed one did."""
    ckpt = str(tmp_path / "ckpt")
    sets = tmp_path / "sets.pkl"
    with open(sets, "wb") as fh:
        pickle.dump(sample_sets(), fh)

    def run(phase):
        env = dict(os.environ, KILL_TEST_CKPT=ckpt, KILL_TEST_PHASE=phase,
                   KILL_TEST_SETS=str(sets), REPRO_GUARDRAIL_BUDGET="256",
                   PYTHONPATH=str(ROOT / "src"))
        env.pop("REPRO_FAULT", None)
        return subprocess.run([sys.executable, "-c", _KILL_SCRIPT],
                              cwd=ROOT, capture_output=True, text=True,
                              env=env, timeout=300)

    out = run("kill")
    assert out.returncode == -9, (out.returncode, out.stderr[-2000:])
    assert "UNREACHABLE" not in out.stdout
    saved = task_ids(ckpt)
    assert saved and all("/span=" in i for i in saved)
    out = run("resume")
    assert out.returncode == 0, out.stderr[-2000:]
    assert "RESUME_OK" in out.stdout
