"""PyTorch port vs JAX package: the incremental flat LFVT.

``repro_torch.core.lfvt_flat.IncrementalLFVT`` is driven through the same
append sequences as the reference's ``IncrementalLFVT``, from numpy
seeds; after every append every array of the capacity view must be
byte-equal (same dtype, same values), and so must the live extents,
``stats``, ``window_bounds`` and ``max_seq_len``. The sequences cover a
capacity regrow, the prepend fast path, the chain re-encode (merge)
fallback, brand-new elements, duplicate and empty appends, and
``compact``. Also: the padding helpers, the device-upload cache dropped
on append, a stale view after a regrow, and the named errors.
"""
import numpy as np
import pytest
import torch

from repro.core.lfvt_flat import IncrementalLFVT as RefIncremental
from repro.core.lfvt_flat import encode as ref_encode
from repro.core.lfvt_flat import flat_walk_caps as ref_caps
from repro.core.lfvt_flat import pad_flat_tables as ref_pad
from repro.core.sets import SetCollection as RefCollection
from repro_torch.core.lfvt_flat import (FlatLFVTError, IncrementalLFVT,
                                        encode, flat_join_mask,
                                        flat_walk_caps, pad_flat_tables)
from repro_torch.core.sets import CollectionValidationError, SetCollection

UNIVERSE = 48
MEASURES = ("jaccard", "cosine", "dice", "overlap")
EXTENTS = ("n_base", "n_live", "t_live", "e_live", "nodes_live",
           "seq_max_live", "version", "universe", "append_work")


def random_sets(rng, n, max_size=8, empty_frac=0.15, zipf=True):
    """Ragged sets with empties and Zipf-shared elements, so appended
    chains intersect existing ones (merge and fast path both occur)."""
    out = []
    for _ in range(n):
        if rng.random() < empty_frac:
            out.append(np.zeros(0, np.int32))
        elif zipf:
            size = int(rng.integers(1, max_size + 1))
            out.append(np.unique(np.minimum(
                rng.zipf(1.3, size=size) - 1, UNIVERSE - 1)))
        else:  # uniform: mostly unseen-element chains
            out.append(rng.integers(0, UNIVERSE,
                                    size=int(rng.integers(1, max_size + 1))))
    return out


def pair(base, grain):
    """The same initial corpus in both packages."""
    return (RefIncremental(RefCollection.from_ragged(base, universe=UNIVERSE),
                           capacity_grain=grain),
            IncrementalLFVT(SetCollection.from_ragged(base, universe=UNIVERSE),
                            capacity_grain=grain))


def assert_same(ref, port):
    fr, fp = ref.flat, port.flat
    for a, b in zip(fr.arrays(), fp.arrays(), strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert (fr.universe, fr.max_seq_len) == (fp.universe, fp.max_seq_len)
    assert ref.stats == port.stats
    for name in EXTENTS:
        assert getattr(ref, name) == getattr(port, name), name
    sizes = np.arange(0, 11)
    for measure in MEASURES:
        for t in (0.5, 2 / 3):
            for x, y in zip(ref.window_bounds(sizes, t, measure),
                            port.window_bounds(sizes, t, measure)):
                np.testing.assert_array_equal(x, y)
    fp.validate()


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("grain", [2, 64])
def test_append_sequence_byte_equal(seed, grain):
    rng = np.random.default_rng(seed)
    ref, port = pair(random_sets(rng, int(rng.integers(0, 20))), grain)
    assert_same(ref, port)
    for step in range(7):
        batch = random_sets(rng, int(rng.integers(0, 6)),
                            zipf=step % 3 != 2)
        if step == 3:
            batch = batch + batch  # duplicates inside one append
        np.testing.assert_array_equal(ref.append(batch), port.append(batch))
        assert_same(ref, port)
    ref.compact()
    port.compact()
    assert_same(ref, port)
    port.append(random_sets(rng, 3))  # compacted tables keep growing
    port.flat.validate()


def test_sequence_covers_every_append_path():
    """One pinned sequence that takes each path at least once, equal to
    the reference after every step."""
    rng = np.random.default_rng(3)
    ref, port = pair(random_sets(rng, 12, empty_frac=0), 2)
    batches = [[np.asarray([0])],                  # prepend fast path
               [np.arange(0, 12)],                 # merge fallback
               [np.asarray([45, 46]), np.asarray([47])],  # new elements
               [], [np.zeros(0, np.int32)],        # empty appends
               [np.asarray([1, 2])] * 3]           # duplicates
    for batch in batches:
        np.testing.assert_array_equal(ref.append(batch), port.append(batch))
        assert_same(ref, port)
    st = port.stats
    assert st["prepend_fast_path"] and st["merged_chains"]
    assert st["new_elements"] and st["regrows"]
    assert st["appends"] == 5  # the empty list returns before counting


def test_masks_equal_rebuild_through_the_walk():
    """The grown table walks like a from-scratch encode of the grown
    collection (columns aligned through s_ids), in the port's walk."""
    rng = np.random.default_rng(7)
    _, enc = pair(random_sets(rng, 10), 4)
    for _ in range(4):
        enc.append(random_sets(rng, 3))
    rebuild = encode(enc.collection().sort_by_size())
    R = SetCollection.from_ragged(random_sets(rng, 8, empty_frac=0.1),
                                  universe=UNIVERSE)
    r_pad, r_sz = R.padded()
    live = enc.flat.s_ids >= 0
    col_of = {int(s): c for c, s in enumerate(rebuild.s_ids)}
    perm = [col_of[int(s)] for s in enc.flat.s_ids[live]]
    from repro_torch.core.tile_join import window_bounds
    for measure in MEASURES:
        lo, hi = enc.window_bounds(r_sz, 0.5, measure)
        m_inc = flat_join_mask(enc.flat, r_pad, r_sz, lo, hi, 0.5, measure,
                               device="cpu").numpy()
        lo, hi = window_bounds(r_sz, rebuild.s_sizes, 0.5, measure)
        m_reb = flat_join_mask(rebuild, r_pad, r_sz, lo, hi, 0.5, measure,
                               device="cpu").numpy()
        assert not m_inc[:, ~live].any()
        np.testing.assert_array_equal(m_inc[:, live], m_reb[:, perm])


def test_device_cache_cleared_on_append():
    enc = IncrementalLFVT(
        SetCollection.from_ragged([np.asarray([1, 2])], universe=UNIVERSE))
    dev = enc.flat.to_device("cpu")
    assert enc.flat.to_device("cpu") is dev  # cached per device
    enc.append([np.asarray([2, 3])])
    assert enc.flat._device == {}  # host mutation dropped every upload
    fresh = enc.flat.to_device("cpu")
    assert fresh is not dev
    assert torch.equal(fresh.s_sizes,
                       torch.from_numpy(enc.flat.s_sizes.astype(np.int32)))


def test_stale_view_serves_pre_append_corpus_after_regrow():
    rng = np.random.default_rng(5)
    enc = IncrementalLFVT(SetCollection.from_ragged(
        random_sets(rng, 8, empty_frac=0), universe=UNIVERSE),
        capacity_grain=2)
    old = enc.flat
    upload = old.to_device("cpu")
    R = SetCollection.from_ragged(random_sets(rng, 5, empty_frac=0),
                                  universe=UNIVERSE)
    r_pad, r_sz = R.padded()
    lo, hi = enc.window_bounds(r_sz, 0.4)
    before = flat_join_mask(old, r_pad, r_sz, lo, hi, 0.4, device="cpu")
    while enc.flat is old:  # append until a regrow swaps the view
        enc.append(random_sets(rng, 3))
    old.validate()
    assert old.to_device("cpu") is upload  # its upload was kept
    after = flat_join_mask(old, r_pad, r_sz, lo, hi, 0.4, device="cpu")
    assert torch.equal(before, after)


def test_padding_helpers_match_reference():
    rng = np.random.default_rng(2)
    sets = random_sets(rng, 9)
    ref = ref_encode(RefCollection.from_ragged(sets, universe=UNIVERSE))
    port = encode(SetCollection.from_ragged(sets, universe=UNIVERSE))
    assert flat_walk_caps(port) == ref_caps(ref)
    caps = dict(n_nodes=port.n_nodes + 3, n_seq=len(port.seq_row) + 5,
                n_entries=len(port.entry_elem) + 2, n_sets=port.n_sets + 4,
                max_seq_len=port.max_seq_len + 7)
    a, b = ref_pad(ref, **caps), pad_flat_tables(port, **caps)
    for x, y in zip(a.arrays(), b.arrays(), strict=True):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert a.max_seq_len == b.max_seq_len
    b.validate()
    T = len(port.seq_row)
    with pytest.raises(FlatLFVTError, match=rf"n_seq.*{T}"):
        pad_flat_tables(port, n_seq=T - 1)
    with pytest.raises(FlatLFVTError, match="n_sets"):
        pad_flat_tables(port, n_sets=0)


def test_named_errors_match_reference():
    ref, port = pair([np.asarray([1, 2])], 64)
    for bad in ([np.asarray([UNIVERSE])], [np.asarray([-1, 3])]):
        with pytest.raises(ValueError) as want:
            ref.append(bad)
        with pytest.raises(CollectionValidationError) as got:
            port.append(bad)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="explicit universe"):
        IncrementalLFVT()


def test_empty_initial_corpus_grows():
    ref = RefIncremental(universe=UNIVERSE)
    port = IncrementalLFVT(universe=UNIVERSE)
    assert_same(ref, port)
    rng = np.random.default_rng(9)
    for _ in range(3):
        batch = random_sets(rng, 4)
        np.testing.assert_array_equal(ref.append(batch), port.append(batch))
        assert_same(ref, port)
