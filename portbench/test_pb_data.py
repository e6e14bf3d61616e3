"""The benchmark's generator against its configuration's spec, on the
configuration's shape and on a small universe with long sets, and its
planted near-copies around t; the configuration against its source."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import data

CONFIGS = Path(__file__).resolve().parent / "configs"


#: the generator's shapes under test: the configuration's, and a small
#: universe with long sets (the repo's synthetic Facebook analogue's)
SHAPES = {"livej-300k": {},
          "small-universe": {"universe": 3110, "mean_len": 20.6,
                             "max_len": 775, "zipf_a": 1.2,
                             "len_sigma": 0.25}}


def config(name: str, **sizes) -> dict:
    base = json.loads((CONFIGS / "livej-300k.json").read_text())
    return {**base, **SHAPES[name], **sizes}


def small(name: str) -> dict:
    return config(name, s_sets=20000, r_pool=4000)


@pytest.fixture(scope="module")
def made():
    return {name: (small(name), data.make(small(name), 2 ** 31 + 5))
            for name in SHAPES}


def jaccard(a, b) -> float:
    inter = len(np.intersect1d(a, b, assume_unique=True))
    return inter / (len(a) + len(b) - inter)


def sets_of(flat):
    off, val = flat
    return [val[off[i]:off[i + 1]] for i in range(len(off) - 1)]


def test_config_lists_every_cut_from_its_source():
    cfg = json.loads((CONFIGS / "livej-300k.json").read_text())
    src = {k: v for k, v in cfg["source_figures"].items() if k != "note"}
    assert sorted(cfg["reduced"]) == sorted(
        k for k, v in src.items() if cfg[k] != v)
    assert set(cfg["cuts"]) == set(cfg["reduced"])
    # every size the source does not give is listed as assumed
    assert {"mean_len", "zipf_a", "len_sigma", "r_batch", "r_pool",
            "planted_share"} <= set(cfg["assumed"])
    assert (cfg["universe"], cfg["mean_len"], cfg["max_len"],
            cfg["zipf_a"], cfg["len_sigma"]) == (43600, 36.2, 300, 1.4, 0.5)
    assert (cfg["s_sets"], cfg["r_batch"], cfg["r_pool"],
            cfg["planted_share"], cfg["threshold"]) == (
                300000, 16384, 131072, 0.1, 0.8)


@pytest.mark.parametrize("name", list(SHAPES))
def test_sets_are_sorted_distinct_and_in_the_universe(made, name):
    cfg, d = made[name]
    for flat in (d["s"], d["pool"]):
        off, val = flat
        assert off[0] == 0 and off[-1] == len(val)
        lens = np.diff(off)
        assert lens.min() >= 1 and lens.max() <= min(cfg["max_len"],
                                                     cfg["universe"])
        assert val.min() >= 0 and val.max() < cfg["universe"]
        # within a set strictly rising: every step inside a set is > 0
        step = np.diff(val.astype(np.int64))
        inside = np.ones(len(val) - 1, bool)
        inside[off[1:-1] - 1] = False
        assert (step[inside] > 0).all()


@pytest.mark.parametrize("name", list(SHAPES))
def test_lengths_follow_the_lognormal_spec(made, name):
    cfg, d = made[name]
    lens = np.diff(d["s"][0])
    # the same truncated, clipped lognormal drawn by numpy
    rng = np.random.default_rng(0)
    mu = np.log(cfg["mean_len"]) - cfg["len_sigma"] ** 2 / 2
    ref = np.clip(rng.lognormal(mu, cfg["len_sigma"], 400000).astype(
        np.int64), 1, min(cfg["max_len"], cfg["universe"]))
    assert lens.mean() == pytest.approx(ref.mean(), rel=0.02)
    assert np.median(lens) == pytest.approx(np.median(ref), abs=1)
    assert np.log(lens).std() == pytest.approx(np.log(ref).std(), rel=0.05)


@pytest.mark.parametrize("name", list(SHAPES))
def test_elements_follow_zipf_popularity(made, name):
    cfg, d = made[name]
    freq = np.bincount(d["s"][1], minlength=cfg["universe"])
    # the most popular ids are the lowest ranks, in order
    assert list(np.argsort(-freq[:50])[:5]) == [0, 1, 2, 3, 4]
    # a head element is in nearly every set it can be; the tail is rare
    n = len(d["s"][0]) - 1
    assert freq[0] > 0.5 * n
    assert freq[cfg["universe"] // 2:].sum() < 0.1 * freq.sum()


def test_large_sets_take_the_large_rule():
    cfg = dict(config("livej-300k"), mean_len=150.0, s_sets=3000)
    gen = data.generator(3, "cpu")
    off, val = data.sample_sets(gen, cfg, cfg["s_sets"])
    lens = np.diff(off)
    assert (lens >= data.LARGE).sum() > 1000
    for s in sets_of((off, val))[:500]:
        assert len(np.unique(s)) == len(s)


def test_same_seed_same_sets_other_seed_other_sets():
    cfg = config("small-universe", s_sets=2000, r_pool=512)
    a, b = data.make(cfg, 11), data.make(cfg, 11)
    c = data.make(cfg, 12)
    for key in ("s", "pool"):
        assert all(np.array_equal(x, y) for x, y in zip(a[key], b[key]))
    assert not np.array_equal(a["s"][1], c["s"][1])
    assert np.array_equal(a["planted_src"], b["planted_src"])
    # a seed past 32 bits works
    data.make(cfg, 2 ** 40 + 3)


@pytest.mark.parametrize("n,ks", [(36, {3, 4, 5}), (37, {3, 4, 5}),
                                  (5, {0, 1, 2}), (1, {0, 1}),
                                  (90, {9, 10, 11})])
def test_copy_edits_straddle_t(n, ks):
    gen = data.generator(1, "cpu")
    got = data.copy_edits(gen, torch.full((3000,), n), 0.8)
    assert set(got.tolist()) == ks


@pytest.mark.parametrize("name", list(SHAPES))
def test_planted_copies_are_near_copies_on_both_sides_of_t(made, name):
    cfg, d = made[name]
    s_sets, pool = sets_of(d["s"]), sets_of(d["pool"])
    planted = np.nonzero(d["planted_src"] >= 0)[0]
    assert len(planted) == round(cfg["planted_share"] * cfg["r_pool"])
    js = []
    for i in planted:
        src = s_sets[d["planted_src"][i]]
        n, k = len(src), int(d["planted_k"][i])
        j = jaccard(pool[i], src)
        assert len(pool[i]) == n
        assert j == pytest.approx((n - k) / (n + k), abs=1e-12)
        js.append(j)
    js = np.array(js)
    assert (js > 0.8 + 1e-12).mean() > 0.3
    assert (js < 0.8 - 1e-12).mean() > 0.3
    assert (np.abs(js - 0.8) < 1e-12).sum() > 10
    fresh = np.nonzero(d["planted_src"] < 0)[0]
    assert (d["planted_k"][fresh] == -1).all()
