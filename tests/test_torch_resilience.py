"""PyTorch port vs JAX package: the resilience layer (DESIGN.md §12).

The fault-plan grammar and its errors, the backoff sequence, the ladder's
retry, degrade and exhaust paths (and that any other exception passes
through it), then chaos parity: every fault site x kind on the MR loop
path (``mr_cf_rs_join``, the walk and the bitmap block reduce) and on the
single-device driver, where the pairs must equal the fault-free run and
``retries``, ``degradations``, ``faults_injected``, ``guardrail_splits``,
``tasks_resumed`` and ``backoff_total`` must equal the reference's under
the same plan and seed. Then checkpoints: full and partial resume, the
named mismatch error, the guardrail's task ids, a checkpoint directory
written by either package resumed by the other with every task resumed
and the same pairs, and a port join killed (SIGKILL) mid-checkpoint in a
subprocess and resumed.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import repro
import repro_torch
from repro.core import resilience as ref_res
from repro.core.config import global_config as ref_config
from repro.core.distributed import mr_cf_rs_join as ref_mr
from repro.core.tile_join import cf_rs_join_device as ref_device
from repro_torch.core import resilience as port_res
from repro_torch.core.config import global_config as port_config
from repro_torch.core.distributed import mr_cf_rs_join as port_mr
from repro_torch.core.join import brute_force_join
from repro_torch.core.tile_join import cf_rs_join_device as port_device

ROOT = pathlib.Path(__file__).resolve().parents[1]
KINDS = ("transient", "persistent", "oom", "storm", "corrupt")
COUNTERS = ("retries", "degradations", "faults_injected", "guardrail_splits",
            "tasks_resumed", "backoff_total")
T = 0.5


def rs_sets(n=30, universe=120, seed=7):
    """R plus a near-duplicate S so mid-threshold joins are non-trivial."""
    rng = np.random.default_rng(seed)
    sets_r, sets_s = [], []
    for _ in range(n):
        b = list(rng.choice(universe, size=rng.integers(3, 12),
                            replace=False))
        sets_r.append(np.array(b))
        dup = b[:-1] if len(b) > 2 and rng.random() < 0.6 else list(b)
        sets_s.append(np.array(dup))
    return sets_r, sets_s


R_SETS, S_SETS = rs_sets()
R, S = repro.as_collection(R_SETS), repro.as_collection(S_SETS)
RT, ST = repro_torch.as_collection(R_SETS), repro_torch.as_collection(S_SETS)
ORACLE = brute_force_join(RT, ST, T)
assert ORACLE


@pytest.fixture(autouse=True)
def fault_free_env(monkeypatch):
    """No REPRO_FAULT plan from the environment; both packages plan
    uncalibrated."""
    for cfg in (ref_config, port_config):
        monkeypatch.setattr(cfg, "fault", "")
        monkeypatch.setattr(cfg, "planner_calibrate", False)


def counters(st: dict) -> dict:
    return {k: st[k] for k in COUNTERS}


# ---------------------------------------------------------------------- #
# grammar, policy, ladder
# ---------------------------------------------------------------------- #
def test_plan_parse_matches_reference():
    spec = "compact:transient;shard_map:persistent ; flat_tables:corrupt:3"
    a = ref_res.FaultPlan.parse(spec, seed=7)
    b = port_res.FaultPlan.parse(spec, seed=7)
    assert [(r.site, r.kind, r.count) for r in b.rules] == [
        (r.site, r.kind, r.count) for r in a.rules]
    assert b.seed == 7 and b.rules_for("regrow") == []
    assert port_res.FaultPlan.parse("").rules == ()
    assert port_res.FAULT_SITES == ref_res.FAULT_SITES
    assert port_res.FAULT_KINDS == ref_res.FAULT_KINDS


@pytest.mark.parametrize("spec", [
    "nowhere:transient", "compact:explode", "compact:transient:0",
    "compact", "compact:transient:1:extra"])
def test_plan_parse_errors_match_reference(spec):
    with pytest.raises(ValueError) as want:
        ref_res.FaultPlan.parse(spec)
    with pytest.raises(ValueError) as got:
        port_res.FaultPlan.parse(spec)
    assert str(got.value) == str(want.value)


def test_build_resilience_activation(monkeypatch):
    assert port_res.build_resilience() is None
    assert port_res.build_resilience(fault_plan="").injector.plan.rules == ()
    assert port_res.build_resilience(checkpoint_dir="x").ledger.dir == "x"
    monkeypatch.setattr(port_config, "fault", "compact:transient")
    monkeypatch.setattr(port_config, "fault_seed", 9)
    res = port_res.build_resilience()
    assert res.injector.plan.rules[0].site == "compact"
    assert res.injector.plan.seed == 9


def test_backoff_sequence_and_cap(monkeypatch):
    pol = port_res.RetryPolicy(max_attempts=5, backoff_base=0.05,
                               backoff_cap=0.3)
    assert [pol.backoff(a) for a in (1, 2, 3, 4, 5)] == [
        0.05, 0.1, 0.2, 0.3, 0.3]
    assert pol.pause(3) == 0.2  # computed, not slept
    monkeypatch.setattr(port_config, "retry_max_attempts", 4)
    monkeypatch.setattr(port_config, "retry_backoff_cap", 0.5)
    got = port_res.RetryPolicy.from_config()
    assert (got.max_attempts, got.backoff_base, got.backoff_cap,
            got.sleep) == (4, 0.05, 0.5, False)


def ladder():
    return port_res.Resilience(
        port_res.RetryPolicy(), port_res.FaultInjector(
            port_res.FaultPlan.parse("")), port_res.TaskLedger())


def test_ladder_retries_degrades_and_exhausts():
    res = ladder()
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise port_res.TransientFault("blip")
        return port_res.sorted_pairs({(1, 2)}), {"reduce": 4}

    pairs, delta = res.run("t1", [("primary", flaky)])
    assert pairs.tolist() == [[1, 2]] and delta["rung"] == "primary"
    assert res.retries == 2 and res.backoff_total == pytest.approx(0.15)

    def broken(exc):
        def fn():
            raise exc("no")
        return fn

    for exc in (port_res.PersistentFault, port_res.SimulatedOOM,
                port_res.PairCapacityError):
        got, delta = res.run(f"t-{exc.__name__}", [
            ("a", broken(exc)), ("b", lambda: (np.zeros((0, 2)), {}))])
        assert delta["rung"] == "b"
    assert res.degradations == [f"t-{e}:a->b" for e in (
        "PersistentFault", "SimulatedOOM", "PairCapacityError")]
    with pytest.raises(port_res.ShardFailedError,
                       match="every degradation rung"):
        res.run("t3", [("a", broken(port_res.PersistentFault)),
                       ("b", broken(port_res.TransientFault))])
    again, _ = res.run("t1", [("primary", flaky)])  # resumed from memory
    assert len(calls) == 3 and res.tasks_resumed == 1
    assert again.tolist() == [[1, 2]]


@pytest.mark.parametrize("exc", [RuntimeError, ValueError, KeyError])
def test_ladder_lets_other_errors_through(exc):
    """Only the four fault classes degrade a rung: a failed kernel build
    or launch (any other exception) propagates."""
    res = ladder()
    later = []

    def fails():
        raise exc("device error")

    with pytest.raises(exc):
        res.run("t", [("kernel", fails), ("oracle", lambda: later.append(1))])
    assert not later and res.degradations == [] and res.retries == 0


# ---------------------------------------------------------------------- #
# chaos parity against the reference
# ---------------------------------------------------------------------- #
def chaos(plan, tmp_path, ref_fn, port_fn, **kw):
    """One join under ``plan`` in each package -> the port's stats."""
    a: dict = {}
    b: dict = {}
    ckpt = {}
    if plan.startswith("checkpoint_write"):
        ckpt = {"ref": str(tmp_path / "ref"), "port": str(tmp_path / "port")}
    try:
        want = ref_fn(R, S, T, stats=a, fault_plan=plan,
                      checkpoint_dir=ckpt.get("ref"), **kw)
    except (ref_res.ResilienceError, ref_res.PairCapacityError) as e:
        # a checkpoint write's only rungs are retry and memory_only: an
        # injected OOM or storm there reaches the caller, in both packages
        with pytest.raises(getattr(port_res, type(e).__name__)):
            port_fn(RT, ST, T, fault_plan=plan,
                    checkpoint_dir=ckpt.get("port"), device="cpu", **kw)
        return None
    got = port_fn(RT, ST, T, stats=b, fault_plan=plan,
                  checkpoint_dir=ckpt.get("port"), device="cpu", **kw)
    assert got == want == ORACLE, plan
    assert counters(b) == counters(a), plan
    return b


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("site", port_res.FAULT_SITES)
def test_loop_chaos_parity(site, kind, tmp_path):
    """The walk (lfvt, with lfvt_ref and the oracle below it) and the
    bitmap block reduce (popcount, the oracle below it), 4 shards."""
    for method in ("lfvt", "popcount"):
        st = chaos(f"{site}:{kind}", tmp_path / method,
                   lambda *a, **k: ref_mr(a[0], a[1], a[2], 4, **k),
                   lambda *a, **k: port_mr(a[0], a[1], a[2], 4, **k),
                   method=method)
        if st is not None and st["faults_injected"]:
            assert st["retries"] or st["degradations"], method


@pytest.mark.parametrize("site", port_res.FAULT_SITES)
def test_device_driver_chaos_parity(site, tmp_path):
    for kind in KINDS:
        for method in ("lfvt", "popcount", "kernel_onehot"):
            chaos(f"{site}:{kind}", tmp_path / f"{kind}-{method}",
                  ref_device, port_device, method=method, r_block=8)


@pytest.mark.parametrize("emit", ["pairs", "mask"])
@pytest.mark.parametrize("measure", ["jaccard", "cosine", "dice", "overlap"])
def test_chaos_parity_measures_and_emit(measure, emit, tmp_path):
    plan = "compact:transient;walk_dispatch:persistent;flat_tables:corrupt"
    for method in ("lfvt", "onehot"):
        a: dict = {}
        b: dict = {}
        want = ref_mr(R, S, 0.6, 3, method=method, measure=measure,
                      emit=emit, stats=a, fault_plan=plan)
        got = port_mr(RT, ST, 0.6, 3, method=method, measure=measure,
                      emit=emit, stats=b, fault_plan=plan, device="cpu")
        assert got == want
        assert got == port_mr(RT, ST, 0.6, 3, method=method,
                              measure=measure, emit=emit, device="cpu")
        assert counters(b) == counters(a)


def test_corruption_detected_and_retried():
    for fn in (lambda **k: port_mr(RT, ST, T, 4, method="lfvt", **k),
               lambda **k: port_device(RT, ST, T, method="lfvt", r_block=8,
                                       **k)):
        st: dict = {}
        assert fn(stats=st, fault_plan="flat_tables:corrupt:2",
                  device="cpu") == ORACLE
        assert st["faults_injected"] >= 1 and st["retries"] >= 1
        assert st["degradations"] == []


def test_env_plan_routes_the_managed_path(monkeypatch):
    """A REPRO_FAULT plan (the config's ``fault``) arms the ladder with
    no kwarg; the counters say so."""
    for cfg in (ref_config, port_config):
        monkeypatch.setattr(cfg, "fault", "walk_dispatch:persistent")
    a: dict = {}
    b: dict = {}
    assert port_mr(RT, ST, T, 4, method="lfvt", stats=b,
                   device="cpu") == ref_mr(R, S, T, 4, method="lfvt",
                                           stats=a) == ORACLE
    assert counters(b) == counters(a) and b["degradations"]


# ---------------------------------------------------------------------- #
# checkpoints
# ---------------------------------------------------------------------- #
DRIVERS = {
    "mr": (lambda **k: ref_mr(R, S, T, 4, method="lfvt", **k),
           lambda **k: port_mr(RT, ST, T, 4, method="lfvt", device="cpu",
                               **k)),
    "mr_popcount": (lambda **k: ref_mr(R, S, T, 4, method="popcount", **k),
                    lambda **k: port_mr(RT, ST, T, 4, method="popcount",
                                        device="cpu", **k)),
    "device": (lambda **k: ref_device(R, S, T, method="lfvt", r_block=8,
                                      **k),
               lambda **k: port_device(RT, ST, T, method="lfvt", r_block=8,
                                       device="cpu", **k)),
}


def npz(d) -> list:
    return sorted(f for f in os.listdir(d) if f.endswith(".npz"))


@pytest.mark.parametrize("driver", sorted(DRIVERS))
def test_checkpoint_full_and_partial_resume(driver, tmp_path):
    _, port = DRIVERS[driver]
    d = str(tmp_path / "ckpt")
    first: dict = {}
    assert port(stats=first, checkpoint_dir=d) == ORACLE
    tasks = npz(d)
    assert tasks and first["tasks_resumed"] == 0
    st: dict = {}
    assert port(stats=st, checkpoint_dir=d) == ORACLE
    assert st["tasks_resumed"] == len(tasks)
    os.remove(os.path.join(d, tasks[0]))
    st = {}
    assert port(stats=st, checkpoint_dir=d) == ORACLE
    assert st["tasks_resumed"] == len(tasks) - 1
    assert npz(d) == tasks


@pytest.mark.parametrize("driver", sorted(DRIVERS))
def test_checkpoint_carries_across_packages(driver, tmp_path):
    """A directory written by one package resumes every task in the
    other, with the same pairs; both write the same task files."""
    ref, port = DRIVERS[driver]
    for writer, reader, name in ((ref, port, "ref"), (port, ref, "port")):
        d = str(tmp_path / name)
        got = writer(checkpoint_dir=d)
        st: dict = {}
        assert reader(stats=st, checkpoint_dir=d) == got == ORACLE
        assert st["tasks_resumed"] == len(npz(d)) > 0
    assert npz(tmp_path / "ref") == npz(tmp_path / "port")


def test_checkpoint_mismatch_is_named(tmp_path):
    d = str(tmp_path / "ckpt")
    port_mr(RT, ST, T, 4, method="lfvt", checkpoint_dir=d, device="cpu")
    with pytest.raises(port_res.CheckpointMismatchError,
                       match=r"mismatched: \['t'\]"):
        port_mr(RT, ST, 0.7, 4, method="lfvt", checkpoint_dir=d,
                device="cpu")
    with pytest.raises(port_res.CheckpointMismatchError,
                       match=r"mismatched: \['method'\]"):
        port_mr(RT, ST, T, 4, method="lfvt_ref", checkpoint_dir=d,
                device="cpu")
    other = repro_torch.as_collection(S_SETS[:-1])
    with pytest.raises(port_res.CheckpointMismatchError,
                       match=r"mismatched: \['S'\]"):
        port_mr(RT, other, T, 4, method="lfvt", checkpoint_dir=d,
                device="cpu")
    assert port_res.collection_digest(ST) == ref_res.collection_digest(S)


def test_checkpoint_write_failure_degrades_to_memory_only(tmp_path):
    st: dict = {}
    got = port_mr(RT, ST, T, 4, method="lfvt", stats=st, device="cpu",
                  checkpoint_dir=str(tmp_path / "c"),
                  fault_plan="checkpoint_write:persistent")
    assert got == ORACLE
    assert any(d.endswith("checkpoint->memory_only")
               for d in st["degradations"])


@pytest.mark.parametrize("guardrail", [True, False])
def test_guardrail_task_ids_match_reference(guardrail, tmp_path,
                                            monkeypatch):
    """A tiny budget splits every shard and block; the splits and the
    task ids (the checkpoint files are named by them) are the
    reference's."""
    monkeypatch.setattr(ref_config, "vmem_budget", 256)
    monkeypatch.setattr(port_config, "guardrail_budget", 256)
    for cfg in (ref_config, port_config):
        monkeypatch.setattr(cfg, "memory_guardrail", guardrail)
    for driver in ("mr", "device"):
        ref, port = DRIVERS[driver]
        a: dict = {}
        b: dict = {}
        assert port(stats=b, checkpoint_dir=str(tmp_path / driver / "p")) \
            == ref(stats=a, checkpoint_dir=str(tmp_path / driver / "r")) \
            == ORACLE
        assert counters(b) == counters(a)
        assert (b["guardrail_splits"] > 0) == guardrail
        assert npz(tmp_path / driver / "p") == npz(tmp_path / driver / "r")


# ---------------------------------------------------------------------- #
# kill -9 mid-checkpoint, then resume (the checkpoint is the survivor)
# ---------------------------------------------------------------------- #
_KILL_SCRIPT = r"""
import os, sys
import numpy as np
import repro_torch
from repro_torch.core.join import brute_force_join

rng = np.random.default_rng(7)
r, s = [], []
for _ in range(30):
    b = list(rng.choice(120, size=rng.integers(3, 12), replace=False))
    r.append(np.array(b))
    s.append(np.array(b[:-1] if len(b) > 2 and rng.random() < 0.6 else b))
R, S = repro_torch.as_collection(r), repro_torch.as_collection(s)
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
    assert st["tasks_resumed"] >= 1, st
    print("RESUME_OK", st["tasks_resumed"])
"""


def test_kill_and_resume_bit_identical(tmp_path):
    ckpt = str(tmp_path / "ckpt")

    def run(phase):
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   KILL_TEST_CKPT=ckpt, KILL_TEST_PHASE=phase)
        env.pop("REPRO_FAULT", None)
        return subprocess.run([sys.executable, "-c", _KILL_SCRIPT],
                              capture_output=True, text=True, env=env,
                              timeout=300)

    out = run("kill")
    assert out.returncode == -9, (out.returncode, out.stderr[-2000:])
    assert "UNREACHABLE" not in out.stdout
    assert npz(ckpt)  # at least one task reached the disk first
    out = run("resume")
    assert out.returncode == 0, out.stderr[-2000:]
    assert "RESUME_OK" in out.stdout
