"""PyTorch port vs JAX package: the host baselines, the host oracles,
planner calibration and strict validation.

Exact comparisons (pairs, stats and coefficients are integers or the
same float expressions evaluated in the same order):

  * the five candidate-based baselines of ``core/baselines.py`` and the
    Algorithm-1 traversals ``cf_rs_join_fvt``/``cf_rs_join_lfvt`` of
    ``core/join.py``: pairs (also against ``brute_force_join``) and every
    stats key, for the 4 measures (dice at exactly 2/3);
  * ``load_calibration`` on the repo's ``BENCH_pr*.json`` and on
    synthetic files (null seconds, the old dict-keyed schema, broken
    JSON, rows the model cannot use, scales past both clamps);
    ``effective_coeffs`` and its memo keyed by file stats;
  * ``build_plan`` with calibration on: method, scores and per-shard
    picks equal to the reference's plan;
  * ``strict_validation``: both drivers raise ``EmptyCollectionError``
    with the reference's message.
"""
import json
import os
import pathlib

import numpy as np
import pytest

import repro
import repro_torch
from repro.core import baselines as ref_base
from repro.core import join as ref_join
from repro.core import planner as ref_planner
from repro.core.config import global_config as ref_config
from repro.core.distributed import mr_cf_rs_join as ref_mr
from repro.core.partition import load_aware_partition as ref_partition
from repro.core.sets import EmptyCollectionError as RefEmpty
from repro.core.tile_join import cf_rs_join_device as ref_device
from repro_torch.core import baselines as port_base
from repro_torch.core import join as port_join
from repro_torch.core import planner as port_planner
from repro_torch.core.config import global_config as port_config
from repro_torch.core.distributed import mr_cf_rs_join as port_mr
from repro_torch.core.partition import load_aware_partition as port_partition
from repro_torch.core.sets import EmptyCollectionError
from repro_torch.core.tile_join import cf_rs_join_device as port_device
from tests._mr_cases import MEASURES, both, sample_sets

ROOT = pathlib.Path(__file__).resolve().parent.parent
MR_T = {"jaccard": 0.5, "cosine": 0.7, "dice": 2 / 3, "overlap": 0.9}
BASELINE_STATS = {
    "allpairs_join": {"candidates"},
    "ppjoin_join": {"candidates", "index_entries"},
    "mr_rp_ppjoin": {"candidates", "shuffle_bytes"},
    "fs_join": {"candidates", "shuffle_bytes"},
    "fasttelp_sj": {"merged_sets", "nodes_visited", "tree_nodes"},
}
SHARDED = ("mr_rp_ppjoin", "fs_join")


@pytest.fixture(scope="module")
def collections():
    return both(*sample_sets())


@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("name", list(BASELINE_STATS))
def test_baseline_matches_reference(name, measure, collections):
    R, S, Rt, St = collections
    t = MR_T[measure]
    args = (3,) if name in SHARDED else ()
    a, b = {}, {}
    want = getattr(ref_base, name)(R, S, t, *args, stats=a, measure=measure)
    got = getattr(port_base, name)(Rt, St, t, *args, stats=b,
                                   measure=measure)
    assert got == want == ref_join.brute_force_join(R, S, t, measure)
    assert want  # the exact-2/3 pair at least
    assert b == a and set(a) == BASELINE_STATS[name]


@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("tree", ["fvt", "lfvt"])
def test_tree_join_matches_reference(tree, measure, collections):
    R, S, Rt, St = collections
    t = MR_T[measure]
    a, b = {}, {}
    want = getattr(ref_join, f"cf_rs_join_{tree}")(R, S, t, stats=a,
                                                   measure=measure)
    got = getattr(port_join, f"cf_rs_join_{tree}")(Rt, St, t, stats=b,
                                                   measure=measure)
    assert got == want == ref_join.brute_force_join(R, S, t, measure)
    assert b == a and set(a) == {"nodes_visited", "tree_nodes"}


def test_pairs_from_counts_matches_reference(collections):
    R, S, Rt, St = collections
    rng = np.random.default_rng(3)
    counts = rng.integers(0, 6, size=(len(R), len(S)))
    args = (R.ids, R.sizes(), S.ids, S.sizes(), 2 / 3)
    for measure in MEASURES:
        assert (port_join.pairs_from_counts(counts, *args, measure=measure)
                == ref_join.pairs_from_counts(counts, *args,
                                              measure=measure))


# ---------------------------------------------------------------------- #
# calibration
# ---------------------------------------------------------------------- #
def _row(method, seconds, impl="jnp", config="method_axis/x", **met):
    metrics = {"m": 512, "n": 512, "universe": 4096, "seconds": seconds,
               "walk_steps": 90_000, "s_flat_bytes": 60_000, **met}
    return {"config": config, "method": method, "impl": impl,
            "metrics": metrics}


SYNTHETIC = {
    "null_seconds.json": {"rows": [_row("bitmap", None),
                                   _row("onehot", 0.0)]},
    "old_schema.json": {"bitmap": {"seconds": 1.0}, "rows": "not a list"},
    "broken.json": "{not json",
    "unusable.json": {"rows": [_row("bitmap", 1.0, config="kernel/x"),
                               _row("lfvt", 1.0, walk_steps=None,
                                    total_seq_tuples=None),
                               _row("bitmap", 1.0, m=0), "row",
                               _row("mystery", 1.0)]},
    # far slower / faster than the model: clamped to the scale limits
    "clamped.json": {"rows": [_row("bitmap", 1e6), _row("onehot", 1e-12),
                              _row("lfvt", 0.05),
                              _row("lfvt", 0.07, impl="ref",
                                   s_flat_bytes=None,
                                   total_seq_tuples=5000)]},
}


def _write(dirpath: pathlib.Path, files: dict) -> list[str]:
    out = []
    for name, doc in files.items():
        p = dirpath / name
        p.write_text(doc if isinstance(doc, str) else json.dumps(doc))
        out.append(str(p))
    return sorted(out)


def test_load_calibration_repo_bench_matches_reference():
    paths = sorted(str(p) for p in ROOT.glob("BENCH_pr*.json"))
    assert paths
    want = ref_planner.load_calibration(paths)
    got = port_planner.load_calibration(paths)
    assert got == want
    assert got != port_planner.DEFAULT_COEFFS  # the rows rescale


@pytest.mark.parametrize("name", list(SYNTHETIC))
def test_load_calibration_synthetic_matches_reference(name, tmp_path):
    paths = _write(tmp_path, {name: SYNTHETIC[name]})
    got = port_planner.load_calibration(paths)
    assert got == ref_planner.load_calibration(paths)
    defaults = port_planner.DEFAULT_COEFFS
    if name == "clamped.json":
        assert got["bitmap"]["fixed"] == defaults["bitmap"]["fixed"] * 5.0
        assert got["onehot"]["fixed"] == defaults["onehot"]["fixed"] * 0.2
        assert got["lfvt_ref"] != defaults["lfvt_ref"]
    else:
        assert got == defaults  # nothing usable: the defaults stand


def test_effective_coeffs_memo_matches_reference(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert port_planner.effective_coeffs() == port_planner.DEFAULT_COEFFS
    _write(tmp_path, {"BENCH_pr1.json": SYNTHETIC["clamped.json"]})
    first = port_planner.effective_coeffs()
    assert first == ref_planner.effective_coeffs() != (
        port_planner.DEFAULT_COEFFS)
    assert port_planner.effective_coeffs() is first  # memoized
    (tmp_path / "BENCH_pr1.json").write_text(
        json.dumps({"rows": [_row("bitmap", 1e-3)]}))
    os.utime(tmp_path / "BENCH_pr1.json", ns=(1, 1))  # a new signature
    assert port_planner.effective_coeffs() == ref_planner.effective_coeffs()
    assert port_planner.effective_coeffs() is not first
    for cfg in (ref_config, port_config):
        monkeypatch.setattr(cfg, "planner_calibrate", False)
    assert port_planner.effective_coeffs() is port_planner.DEFAULT_COEFFS


def _plan_sets(universe, n=40):
    rng = np.random.default_rng(2)
    sets = [rng.integers(0, universe, size=int(rng.integers(3, 12)))
            for _ in range(n)]
    return sets, sets[::-1]


@pytest.mark.parametrize("universe", [256, 2 ** 13, 2 ** 21])
@pytest.mark.parametrize("driver", ["device", "mr", "mesh"])
def test_calibrated_plan_matches_reference(driver, universe, monkeypatch):
    """With the repo's BENCH rows in the working directory both planners
    rescale alike: the same scores and the same pick (per shard on the
    MR loop path)."""
    monkeypatch.chdir(ROOT)
    r, s = _plan_sets(universe)
    R, S, Rt, St = both(r, s)
    kw = dict(driver="device" if driver == "device" else "mr",
              method="auto", has_mesh=driver == "mesh")
    a_part = b_part = None
    if driver == "mr":
        a_part = ref_partition(R, S, 0.5, 3)
        b_part = port_partition(Rt, St, 0.5, 3)
    a = ref_planner.build_plan(R, S, 0.5, part=a_part, **kw)
    b = port_planner.build_plan(Rt, St, 0.5, part=b_part, **kw)
    assert b.to_dict() == a.to_dict()
    assert b.decided == "cost_model" and b.scores
    assert port_planner.effective_coeffs() != port_planner.DEFAULT_COEFFS


# ---------------------------------------------------------------------- #
# strict validation
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("empty", ["R", "S"])
@pytest.mark.parametrize("driver", ["device", "mr"])
def test_strict_validation_raises_like_reference(driver, empty, monkeypatch):
    r, s = sample_sets(n_r=6, n_s=5)
    r, s = ([], s) if empty == "R" else (r, [])
    R, S = repro.as_collection(r), repro.as_collection(s)
    Rt, St = repro_torch.as_collection(r), repro_torch.as_collection(s)
    for cfg in (ref_config, port_config):
        monkeypatch.setattr(cfg, "strict_validation", True)
        monkeypatch.setattr(cfg, "fault", "")
    if driver == "device":
        with pytest.raises(RefEmpty) as want:
            ref_device(R, S, 0.5)
        with pytest.raises(EmptyCollectionError) as got:
            port_device(Rt, St, 0.5, device="cpu")
    else:
        with pytest.raises(RefEmpty) as want:
            ref_mr(R, S, 0.5, 2)
        with pytest.raises(EmptyCollectionError) as got:
            port_mr(Rt, St, 0.5, 2, device="cpu")
    assert str(got.value) == str(want.value)
    assert issubclass(EmptyCollectionError, ValueError)
    monkeypatch.setattr(port_config, "strict_validation", False)
    assert port_mr(Rt, St, 0.5, 2, device="cpu") == set()
