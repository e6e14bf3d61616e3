"""The harness driven on the CPU at a small size: a sound run is correct;
the control and each planted fault of the timed path are not; nothing it
imports is JAX or the JAX package; BENCHMARK.json keeps to its contract."""
import json
import re
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest
import torch

from portbench import control, run

ROOT = run.ROOT
#: the CPU runs' sizes; the universe is cut as well, so that the
#: reference's dense membership matrices stay small on the CPU
SMALL = {"s_sets": 3000, "r_pool": 2048, "r_batch": 512, "universe": 3110}
CELL = "livej.auto"


@pytest.fixture(scope="module")
def bench():
    return run.load_json(ROOT / "BENCHMARK.json")


def small_run(bench, make_join=None, device="cpu", workload=CELL):
    return run.run_cell(bench, workload, 2 ** 32 + 17, 0.3, False, device,
                        time.perf_counter(), make_join=make_join,
                        sizes=SMALL)


def fault(kind):
    """The timed path broken one way: ``stale`` answers every op with the
    previous op's pairs (state returned unchanged), ``half`` joins half of
    the batch, ``altered`` changes one answer where it is produced."""
    def make(made, device):
        import repro_torch
        from repro_torch.core.sets import SetCollection
        prev = []

        def join(R, S, t, **kw):
            if kind == "half":
                k = len(R) // 2
                R = SetCollection(R.sets[:k], R.universe, R.ids[:k])
            res = repro_torch.join(R, S, t, **kw)
            if kind == "stale":
                prev.append(res)
                return prev[-2] if len(prev) > 1 else res
            if kind == "altered":
                pairs = sorted(res.pairs)
                r, s = pairs[0]
                pairs[0] = (r, (s + 1) % len(S))
                return SimpleNamespace(pairs=frozenset(pairs),
                                       stats=res.stats)
            return res
        return join
    return make


def test_sound_run_is_correct(bench):
    out = small_run(bench)
    assert out["correct"], out
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["metrics"]) == {"r_sets_per_s", "join_p95_ms", "setup_s"}
    assert list(out)[-1] == "checks"
    assert out["checks"] == {"missing_pairs": {"value": 0, "limit": 0},
                             "extra_pairs": {"value": 0, "limit": 0}}
    assert any("reference_pairs=" in line and "reference_pairs=0 " not in
               line for line in out["log"])


@pytest.mark.parametrize("kind", ["stale", "half", "altered"])
def test_a_broken_timed_path_is_not_correct(bench, kind):
    out = small_run(bench, make_join=fault(kind))
    assert not out["correct"], out
    assert sum(c["value"] for c in out["checks"].values()) > 0


def test_the_control_is_not_correct(bench):
    universe = run.cell_parts(bench, CELL)[1]["universe"]
    out = small_run(bench, make_join=lambda made, dev: control.sketch_join(
        made, dev, universe))
    assert not out["correct"]
    assert out["checks"]["extra_pairs"]["value"] > 0


def test_forbidden_modules_compares_whole_names():
    assert run.forbidden_modules(["repro_torch", "repro_torch.api",
                                  "reprox", "numpy"]) == []
    assert run.forbidden_modules(["repro.core.join", "jax.numpy", "jaxlib",
                                  "flax.linen", "repro_torch"]) == [
        "flax", "jax", "jaxlib", "repro"]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys, time\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from portbench import run, control, data, reference, roofline, "
        "trace, yardstick\n"
        "bench = run.load_json(run.ROOT / 'BENCHMARK.json')\n"
        "for m in bench['per_layer']:\n"
        "    run.reader(m['name'])\n"
        f"out = run.run_cell(bench, {CELL!r}, 3, 0.2, False, 'cpu', "
        f"time.perf_counter(), sizes={SMALL!r})\n"
        "assert out['correct']\n"
        "print('LOADED', run.forbidden_modules(), "
        "sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'repro')))\n")
    got = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert got.returncode == 0, got.stderr[-3000:]
    assert "LOADED [] []" in got.stdout


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_to_its_contract(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert bench["command"] == ["python3", "portbench/run.py"]
    rs = bench["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (ROOT / "portbench" / "traffic"
                / f"{w['traffic']}.json").exists()
        assert w["config"] in {c["name"] for c in bench["configs"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert e2e == {"r_sets_per_s", "join_p95_ms", "peak_mem_gb", "setup_s"}
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").exists()
        for w in m.get("workloads", []):
            assert w in {c["name"] for c in bench["workloads"]}


def test_readers_find_nothing_without_a_trace(bench):
    ctx = SimpleNamespace(trace=None, ops=[], spans={"first_op_s": 1.5})
    got = {m["name"]: run.reader(m["name"])(ctx) for m in bench["per_layer"]}
    assert got.pop("first_op_s") == 1.5
    assert set(got.values()) == {None}


@pytest.mark.cuda
def test_a_small_run_on_the_card_is_correct(bench):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; torch sees none")
    for workload in ("livej.lfvt", CELL):
        out = small_run(bench, device="cuda", workload=workload)
        assert out["correct"], out
        assert out["device"]["platform"] == "gpu"


def mix_bench(root, traffic: dict) -> dict:
    """A benchmark of one cell under ``root``: the configuration's file
    and the traffic mix ``traffic``."""
    (root / "portbench" / "configs").mkdir(parents=True)
    (root / "portbench" / "traffic").mkdir()
    cfg = json.loads((ROOT / "portbench" / "configs"
                      / "livej-300k.json").read_text())
    (root / "portbench" / "configs" / "lj.json").write_text(json.dumps(cfg))
    (root / "portbench" / "traffic" / "mix.json").write_text(
        json.dumps(traffic))
    return {"configs": [{"name": "lj", "file": "portbench/configs/lj.json"}],
            "workloads": [{"name": "lj.mix", "config": "lj",
                           "traffic": "mix", "chips": 1}],
            "end_to_end": [{"name": "r_sets_per_s", "unit": "sets/s"}],
            "per_layer": []}


def test_a_traffic_mix_passes_its_join_arguments_through(tmp_path):
    """A later mix adds a file, not code: its ``join`` dict reaches
    ``repro_torch.join`` as it is, beside the configuration's."""
    bench = mix_bench(tmp_path, {
        "loop": "closed", "clients": 1, "op": "join",
        "join": {"method": "popcount", "n_shards": 2}, "why": "a test"})
    seen = []

    def make(made, device):
        import repro_torch

        def join(R, S, t, **kw):
            seen.append((t, tuple(sorted(kw.items()))))
            return repro_torch.join(R, S, t, **kw)
        return join
    out = run.run_cell(bench, "lj.mix", 5, 0.2, False, "cpu",
                       time.perf_counter(), make_join=make,
                       sizes={"s_sets": 2000, "r_pool": 1024, "r_batch": 256,
                              "universe": 3110}, root=tmp_path)
    assert out["correct"]
    assert set(seen) == {(0.8, (
        ("device", torch.device("cpu")), ("emit", "pairs"),
        ("measure", "jaccard"), ("method", "popcount"), ("n_shards", 2),
        ("r_block", None)))}


@pytest.mark.parametrize("change", [
    {"clients": 4}, {"loop": "open"}, {"op": "dedup"}, {"rate": 10},
    {"join": {"measure": "cosine"}}, {"join": {"r_block": 256}}])
def test_a_traffic_mix_the_harness_cannot_run_as_written_is_refused(
        change):
    traffic = {"loop": "closed", "clients": 1, "op": "join",
               "join": {"method": "lfvt"}, **change}
    cfg = json.loads((ROOT / "portbench" / "configs"
                      / "livej-300k.json").read_text())
    with pytest.raises(ValueError):
        run.join_args(traffic, cfg)


def test_the_cells_traffic_mixes_are_runnable(bench):
    for w in bench["workloads"]:
        cell, cfg, traffic = run.cell_parts(bench, w["name"])
        kw = run.join_args(traffic, cfg)
        assert kw["method"] in ("lfvt", "auto")
        assert (kw["measure"], kw["emit"]) == ("jaccard", "pairs")


@pytest.mark.parametrize("method,kernel", [
    ("lfvt", "lfvt_walk_kernel(int const*)"),
    ("popcount", "void bitmap_join_kernel<false>(int const*)"),
    ("kernel_onehot", "void onehot_join_kernel<1, 128>(CUtensorMap)")])
def test_roofline_reader_sums_bounds_over_kernel_time(method, kernel):
    import numpy as np

    from portbench import data, roofline
    from portbench.trace import Trace
    cfg = {"universe": 500, "mean_len": 10.0, "max_len": 40, "zipf_a": 1.3,
           "len_sigma": 0.5, "threshold": 0.8, "s_sets": 300, "r_pool": 200,
           "planted_share": 0.2}
    made = data.make(cfg, 3)
    rows = np.arange(0, 200, 2)
    ops = [{"rows": rows, "pair_r": rows[:5],
            "stats": {"method": method, "plan": {"r_block": 32}}}]
    ctx = SimpleNamespace(
        trace=Trace(device=[(kernel, 0, 10 ** 6), ("other", 0, 10 ** 7)],
                    start=0, end=10 ** 7),
        ops=ops, cfg=cfg, threshold=0.8, pool=made["pool"], s=made["s"],
        spans={}, device=torch.device("cpu"))
    share = run.reader("join_kernels_roofline")(ctx)
    s = roofline.SortedS(*made["s"], cfg["universe"])
    family = {"lfvt": "walk", "popcount": "popcount",
              "kernel_onehot": "onehot"}[method]
    words = s.words("cpu") if family == "popcount" else None
    want = sum(roofline.block_bounds(
        family, *made["pool"], rows[k:k + 32],
        int((k == 0) * 5), s, 0.8, "cpu", words)[0]
        for k in range(0, len(rows), 32))
    assert share == pytest.approx(100 * want / 1e-3)
    busy = run.reader("join_kernels_busy_share")(ctx)
    assert busy == pytest.approx(10.0)
    ops[0]["stats"]["method"] = "lfvt_ref"
    assert run.reader("join_kernels_roofline")(ctx) is None
