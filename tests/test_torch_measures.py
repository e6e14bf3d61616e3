"""PyTorch port vs JAX package: the integer-exact measure layer.

``repro_torch.core.measures`` (torch int32 predicate) and
``repro_torch.core.tile_join.window_bounds`` are held against
``repro.core.measures`` / ``repro.core.tile_join.window_bounds`` on the
same numpy inputs. Every comparison is exact: the outputs are integers
and booleans.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import measures as ref_measures
from repro.core.tile_join import window_bounds as ref_window_bounds
from repro_torch.core import measures as port_measures
from repro_torch.core.tile_join import window_bounds as port_window_bounds

MEASURES = ("jaccard", "cosine", "dice", "overlap")
THRESHOLDS = (0.5, 0.7, 0.9, 2 / 3)


def _grid(n=14):
    f, r, s = np.meshgrid(np.arange(n), np.arange(n), np.arange(n),
                          indexing="ij")
    return (f.reshape(-1).astype(np.int32), r.reshape(-1).astype(np.int32),
            s.reshape(-1).astype(np.int32))


@pytest.mark.parametrize("t", THRESHOLDS)
@pytest.mark.parametrize("measure", MEASURES)
def test_device_qualify_exhaustive_grid(measure, t):
    """Every (f, r, s) in [0, 14)^3: torch int32 predicate == jnp one."""
    f, r, s = _grid()
    want = np.asarray(ref_measures.device_qualify(
        jnp.asarray(f), jnp.asarray(r), jnp.asarray(s), t, measure))
    got = port_measures.device_qualify(
        torch.from_numpy(f), torch.from_numpy(r), torch.from_numpy(s), t,
        measure).numpy()
    assert got.dtype == np.bool_
    np.testing.assert_array_equal(got, want)
    # and both agree with the arbitrary-precision host predicate
    np.testing.assert_array_equal(
        got, port_measures.numpy_qualify(f[:, None], r, s, t,
                                         measure).diagonal())


def test_device_qualify_broadcasts_tiles():
    """(m, 1) x (1, n) against an (m, n) count tile, as the walk uses it."""
    rng = np.random.default_rng(0)
    counts = rng.integers(0, 20, size=(6, 9)).astype(np.int32)
    r = rng.integers(1, 20, size=(6, 1)).astype(np.int32)
    s = rng.integers(1, 20, size=(1, 9)).astype(np.int32)
    for measure in MEASURES:
        want = np.asarray(ref_measures.device_qualify(
            jnp.asarray(counts), jnp.asarray(r), jnp.asarray(s), 0.6, measure))
        got = port_measures.device_qualify(
            torch.from_numpy(counts), torch.from_numpy(r),
            torch.from_numpy(s), 0.6, measure).numpy()
        np.testing.assert_array_equal(got, want)


def test_pinned_two_thirds_boundary():
    """|R| = |S| = 5, f = 4 at t = 2/3: Jaccard is exactly 4/6 = 2/3, the
    pair the float32 predicate misses. Both packages must keep it."""
    one = np.array([4], np.int32), np.array([5], np.int32)
    for pkg, conv in ((ref_measures, jnp.asarray), (port_measures,
                                                    torch.from_numpy)):
        f, r = (conv(x) for x in one)
        assert bool(np.asarray(pkg.device_qualify(f, r, r, 2 / 3))[0])
        assert not bool(np.asarray(pkg.device_qualify(f - 1, r, r,
                                                      2 / 3))[0])


@pytest.mark.parametrize("measure", MEASURES)
def test_window_bounds_match(measure):
    rng = np.random.default_rng(7)
    s_desc = np.sort(rng.integers(0, 60, size=200))[::-1].astype(np.int32)
    r_sizes = rng.integers(0, 70, size=300).astype(np.int32)
    for t in THRESHOLDS + (0.25, 1.0):
        lo_r, hi_r = ref_window_bounds(r_sizes, s_desc, t, measure)
        lo_p, hi_p = port_window_bounds(r_sizes, s_desc, t, measure)
        assert lo_p.dtype == lo_r.dtype and hi_p.dtype == hi_r.dtype
        np.testing.assert_array_equal(lo_p, lo_r)
        np.testing.assert_array_equal(hi_p, hi_r)


@pytest.mark.parametrize("measure", MEASURES)
def test_validate_guard_matches(measure):
    """The 2^31 guard accepts and refuses exactly what the reference
    does, with the same message."""
    for t in (0.5, 2 / 3, 0.123457, 1e-4, 0.999999):
        for n in (10, 1000, 40_000, 2_000_000):
            outcomes = []
            for pkg in (ref_measures, port_measures):
                try:
                    pkg.get_measure(measure).validate(t, n)
                    outcomes.append(None)
                except ValueError as e:
                    outcomes.append(str(e))
            assert outcomes[0] == outcomes[1], (measure, t, n)


def test_threshold_fraction_and_errors_match():
    for t in THRESHOLDS + (0.875, 1 / 7, 1.0):
        assert (port_measures.threshold_fraction(t)
                == ref_measures.threshold_fraction(t))
    with pytest.raises(ValueError, match="threshold must be in"):
        port_measures.threshold_fraction(0.0)
    with pytest.raises(ValueError, match="unknown measure"):
        port_measures.device_qualify(torch.zeros(1), torch.zeros(1),
                                     torch.zeros(1), 0.5, "hamming")
