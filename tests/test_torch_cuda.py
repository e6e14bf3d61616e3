"""The port's CUDA kernel K1 against its plain PyTorch version, on a GPU.

Marked ``cuda``: every test skips (with a reason) where torch sees no
CUDA device. The file imports neither jax nor the JAX package, so it runs
on a machine that has only the port's dependencies::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Inputs are made from a seed with numpy; masks, counts, walk_steps and
early_stops must be bit-equal (integers and booleans, tolerance 0).
"""
import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core.sets import SetCollection
from repro_torch.core.tile_join import window_bounds
from repro_torch.kernels import lfvt_walk, ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def skewed(seed, n, universe, max_size):
    rng = np.random.default_rng(seed)
    return SetCollection.from_ragged(
        [rng.integers(0, universe, size=int(min(max_size, rng.zipf(1.4))))
         for _ in range(n)], universe=universe)


def walk_inputs(device, seed, t, measure, n_r=300, n_s=500, tm=16):
    R = skewed(seed, n_r, 200, 48)
    flat = skewed(seed + 1, n_s, 200, 48).sort_by_size().flat_lfvt()
    r_pad = torch.tensor(R.padded()[0], device=device)
    r_sz = R.sizes()
    lo, hi = window_bounds(r_sz, flat.s_sizes, t, measure)
    ti, operands, _ = ops.walk_operands(flat, r_pad, r_sz, lo, hi, tm)
    kw = dict(t=t, measure=measure, max_steps=int(flat.max_seq_len), tm=tm)
    return ti, operands, kw


def assert_bit_equal(got, want):
    for g, w, name in zip(got, want, ("masks", "counts", "walk_steps",
                                      "early_stops")):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g.cpu(), w.cpu()), name


@pytest.mark.parametrize("seed,measure,t", [
    (0, "jaccard", 0.5), (1, "cosine", 0.7), (2, "dice", 2 / 3),
    (3, "overlap", 0.9), (4, "jaccard", 0.9)])
def test_kernel_matches_plain(cuda, seed, measure, t):
    ti, operands, kw = walk_inputs(cuda, seed, t, measure)
    before = lfvt_walk.lfvt_walk_live_tiled.launches
    got = lfvt_walk.lfvt_walk_live_tiled(ti, *operands, **kw)
    torch.cuda.synchronize()
    assert lfvt_walk.lfvt_walk_live_tiled.launches == before + 1
    assert_bit_equal(got, lfvt_walk.lfvt_walk_live_tiled_ref(
        ti, *operands, **kw))
    cpu = [x.cpu() for x in operands]
    assert_bit_equal(got, lfvt_walk.lfvt_walk_live_tiled_ref(
        ti.cpu(), *cpu, **kw))


def test_kernel_checks_operands(cuda):
    ti, operands, kw = walk_inputs(cuda, 5, 0.5, "jaccard")
    bad = list(operands)
    bad[0] = bad[0].long()
    with pytest.raises(ValueError, match="lane_pos must be int32"):
        lfvt_walk.lfvt_walk_live_tiled(ti, *bad, **kw)
    bad = list(operands)
    bad[1] = bad[1].cpu()
    with pytest.raises(ValueError, match="lane_rem is on cpu"):
        lfvt_walk.lfvt_walk_live_tiled(ti, *bad, **kw)


@pytest.mark.parametrize("emit", ["pairs", "mask"])
def test_join_on_cuda_matches_cpu(cuda, emit):
    R, S = skewed(7, 700, 300, 40), skewed(8, 600, 300, 40)
    for measure in ("jaccard", "cosine", "dice", "overlap"):
        st_g: dict = {}
        st_c: dict = {}
        got = repro_torch.join(R, S, 0.6, method="lfvt", measure=measure,
                               emit=emit, stats=st_g, r_block=256)
        want = repro_torch.join(R, S, 0.6, method="lfvt", measure=measure,
                                emit=emit, stats=st_c, r_block=256,
                                device="cpu")
        assert st_g["device"].startswith("cuda")
        assert got.pairs == want.pairs, measure
        for key in ("pair_count", "walk_steps", "early_stops", "live_tiles",
                    "regrows"):
            assert st_g[key] == st_c[key], (measure, key)
