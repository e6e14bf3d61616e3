"""PyTorch port vs JAX package: the flat LFVT encoding and its walks.

Holds ``repro_torch.core.lfvt_flat`` and the host planning pieces of
``repro_torch.kernels.lfvt_walk`` against the reference on the same
numpy inputs, exactly: every ``FlatLFVT`` array byte for byte,
``from_arrays`` round trips, the resolved walk lanes (``entry_state``),
the live row-tile plan, and the whole-block walk mask
(``flat_join_mask``). Also the port's dataset generator against the
reference's, set for set.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fvt as ref_fvt
from repro.core import lfvt_flat as ref_flat
from repro.core.sets import SetCollection as RefCollection
from repro.core.tile_join import window_bounds as ref_window_bounds
from repro.data import synth as ref_synth
from repro.kernels import lfvt_walk as ref_walk
from repro_torch.core import fvt as port_fvt
from repro_torch.core import lfvt_flat as port_flat
from repro_torch.core.sets import SetCollection as PortCollection
from repro_torch.data import synth as port_synth
from repro_torch.kernels import lfvt_walk as port_walk

CPU = torch.device("cpu")


def ragged(seed, n=24, universe=40, max_size=12, skew=False,
           empty_frac=0.15):
    """Ragged sets with raw duplicate elements, empties, optional Zipf."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        if rng.random() < empty_frac:
            out.append(np.zeros(0, np.int32))
            continue
        size = (int(min(max_size, rng.zipf(1.6))) if skew
                else int(rng.integers(1, max_size + 1)))
        out.append(rng.integers(0, universe, size=size))
    return out


def both(sets, universe):
    return (RefCollection.from_ragged(sets, universe=universe),
            PortCollection.from_ragged(sets, universe=universe))


def assert_flat_equal(port, ref):
    a, b = port.arrays(), ref.arrays()
    assert len(a) == len(b) == 15
    for x, y, f in zip(a, b, [f.name for f in dataclasses.fields(ref)]):
        assert x.dtype == y.dtype, f
        assert x.shape == y.shape, f
        assert x.tobytes() == y.tobytes(), f
    assert (port.universe, port.max_seq_len) == (ref.universe,
                                                 ref.max_seq_len)


CASES = [dict(seed=s, skew=k, max_size=m)
         for s, k, m in ((0, False, 3), (1, True, 8), (2, False, 12),
                         (3, True, 12), (4, True, 16))]


@pytest.mark.parametrize("case", CASES, ids=lambda c: str(c["seed"]))
def test_encode_arrays_byte_equal(case):
    R_ref, R_port = both(ragged(**case), 40)
    assert_flat_equal(port_flat.encode(R_port), ref_flat.encode(R_ref))
    # the uncompressed (one tuple per node) encoding agrees too
    assert_flat_equal(port_flat.encode(R_port, tree=port_fvt.FVT(R_port)),
                      ref_flat.encode(R_ref, tree=ref_fvt.FVT(R_ref)))


def test_encode_edge_cases_byte_equal():
    for sets, universe in (([], 8), ([np.zeros(0, np.int32)] * 3, 8),
                           ([np.array([5])], 8),
                           ([np.arange(6)] * 4, 6)):
        R_ref, R_port = both(sets, universe)
        assert_flat_equal(port_flat.encode(R_port), ref_flat.encode(R_ref))


def test_flat_lfvt_memo_is_the_ports_encoding():
    _, S = both(ragged(5, skew=True), 40)
    flat = S.sort_by_size().flat_lfvt()
    assert isinstance(flat, port_flat.FlatLFVT)
    assert flat.validate() is flat


def test_from_arrays_round_trips_reference_tables():
    R_ref, R_port = both(ragged(6, skew=True), 40)
    ref = ref_flat.encode(R_ref)
    got = port_flat.FlatLFVT.from_arrays(ref.arrays(), ref.universe,
                                         ref.max_seq_len)
    assert_flat_equal(got, ref)
    assert got.nbytes() == ref.nbytes()
    for a in range(40):
        assert list(got.walk(a)) == list(ref.walk(a)), a
    # and the reference can take the port's arrays back
    port = port_flat.encode(R_port)
    back = ref_flat.FlatLFVT(*[a.copy() for a in port.arrays()],
                             universe=port.universe,
                             max_seq_len=port.max_seq_len)
    assert_flat_equal(port, back)


def test_from_arrays_rejects_bad_tables():
    _, S = both(ragged(7), 40)
    arrs = list(port_flat.encode(S).arrays())
    with pytest.raises(port_flat.FlatLFVTError, match="expected 15"):
        port_flat.FlatLFVT.from_arrays(arrs[:-1], 40, 4)
    arrs[7] = arrs[7].copy()
    arrs[7][0] = 10_000  # seq_row outside [0, n_sets)
    with pytest.raises(port_flat.FlatLFVTError, match="seq_row"):
        port_flat.FlatLFVT.from_arrays(arrs, 40, 4)


def test_to_device_uploads_once_per_device():
    _, S = both(ragged(8), 40)
    flat = port_flat.encode(S)
    dev = flat.to_device("cpu")
    assert flat.to_device(CPU) is dev
    for name, t in dev._asdict().items():
        assert t.dtype == torch.int32, name
        np.testing.assert_array_equal(t.numpy(), getattr(flat, name))


def _block(seed, t, measure, n_r=37, n_s=29):
    """Same R block + S table in both packages, size-sorted and
    tile-padded as the dispatch makes it."""
    S_ref, S_port = both(ragged(seed, n=n_s, skew=True), 40)
    R_ref, R_port = both(ragged(seed + 100, n=n_r, skew=True), 40)
    ref = S_ref.sort_by_size().flat_lfvt()
    port = S_port.sort_by_size().flat_lfvt()
    r_pad, r_sz = R_ref.padded()
    lo, hi = ref_window_bounds(r_sz, ref.s_sizes, t, measure)
    return ref, port, r_pad, r_sz, lo, hi


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_entry_state_lanes_equal(seed):
    ref, port, r_pad, *_ = _block(seed, 0.5, "jaccard")
    pos_r, rem_r = ref_walk.entry_state(ref.to_device(), jnp.asarray(r_pad))
    pos_p, rem_p = port_walk.entry_state(port.to_device(CPU),
                                         torch.from_numpy(r_pad.copy()))
    assert pos_p.dtype == rem_p.dtype == torch.int32
    np.testing.assert_array_equal(pos_p.numpy(), np.asarray(pos_r))
    np.testing.assert_array_equal(rem_p.numpy(), np.asarray(rem_r))


def test_plan_row_tiles_equal_and_ragged_tail_raises():
    rng = np.random.default_rng(3)
    lo = rng.integers(0, 5, 64)
    hi = lo + rng.integers(0, 2, 64) * rng.integers(0, 3, 64)
    for tm in (4, 8, 16):
        np.testing.assert_array_equal(port_walk.plan_row_tiles(lo, hi, tm),
                                      ref_walk.plan_row_tiles(lo, hi, tm))
    with pytest.raises(port_walk.TileShapeError, match="not a multiple"):
        port_walk.plan_row_tiles(lo[:10], hi[:10], 4)


@pytest.mark.parametrize("measure,t", [("jaccard", 0.5), ("cosine", 0.7),
                                       ("dice", 2 / 3), ("overlap", 0.9)])
def test_flat_join_mask_equal(measure, t):
    ref, port, r_pad, r_sz, lo, hi = _block(4, t, measure)
    want = np.asarray(ref_flat.flat_join_mask(ref, r_pad, r_sz, lo, hi, t,
                                              measure))
    got = port_flat.flat_join_mask(port, r_pad, r_sz, lo, hi, t, measure,
                                   device="cpu")
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["livej", "dblp"])
def test_synth_datasets_equal(name):
    """The port's generator draws the same sets from the same seed."""
    scale = 120 / ref_synth.DATASETS[name].n_sets
    a = ref_synth.make_join_dataset(name, scale=scale, seed=11)
    b = port_synth.make_join_dataset(name, scale=scale, seed=11)
    for x, y in zip(a, b):
        assert x.universe == y.universe and len(x) == len(y)
        for u, v in zip(x.sets, y.sets):
            np.testing.assert_array_equal(u, v)
