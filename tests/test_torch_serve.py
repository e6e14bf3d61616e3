"""PyTorch port vs JAX package: the online dedup service.

``repro_torch.DedupServeEngine(device="cpu")`` and the reference's
``repro.serve.dedup.DedupServeEngine`` serve the same request streams,
made from numpy seeds, over the same corpus: every ``DedupResult`` field
but ``latency_s`` (the batch's stats dict included) and ``engine.stats``
must be equal, for both walk schedules (``"host"``: K1's plain version;
``"device"``: K6's), ``admit`` none and survivors, ``step`` and
``drain``, and all four measures. Also ``docs_to_sets``, ``similarity``
and ``DedupPipeline.filter_stream`` against the reference's, and the
engine's own errors. The engine on the GPU is held against this CPU
path in ``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest

from repro.core.sets import SetCollection as RefCollection
from repro.core.sets import similarity as ref_similarity
from repro.data.pipeline import DedupPipeline as RefPipeline
from repro.data.synth import docs_to_sets as ref_docs_to_sets
from repro.serve.dedup import DedupServeEngine as RefEngine
from repro_torch import (DedupPipeline, DedupResult, DedupServeEngine,
                         DeviceUnavailableError)
from repro_torch.core.sets import SetCollection, similarity
from repro_torch.data.synth import docs_to_sets

UNI = 40
MEASURES = ("jaccard", "cosine", "dice", "overlap")
FIELDS = ("rid", "is_dup", "matches", "admitted", "corpus_id", "stats")


def zipf_set(rng, lmax=8):
    size = int(rng.integers(1, lmax + 1))
    return np.unique(np.minimum(rng.zipf(1.3, size=size) - 1, UNI - 1))


def corpus_sets(seed=0, n=25):
    rng = np.random.default_rng(seed)
    return [zipf_set(rng) for _ in range(n)]


def stream(seed, n=22, repeats=6):
    """Requests with repeats of earlier ones, so that duplicates within a
    batch and across batches both occur under admission."""
    rng = np.random.default_rng(seed)
    out = [zipf_set(rng) for _ in range(n)]
    for _ in range(repeats):
        out.insert(int(rng.integers(1, len(out))),
                   out[int(rng.integers(0, len(out) - 1))])
    return out


def engines(corpus, **kw):
    return (RefEngine(RefCollection.from_ragged(corpus, universe=UNI), **kw),
            DedupServeEngine(SetCollection.from_ragged(corpus, universe=UNI),
                             device="cpu", **kw))


def serve(eng, queries, use_drain):
    for q in queries:
        eng.submit(q)
    if use_drain:
        return eng.drain()
    out = []
    while eng.queue_depth:
        out.extend(eng.step())
    return out


def assert_same_results(want, got, fields=FIELDS):
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert isinstance(g, DedupResult)
        for f in fields:
            assert getattr(g, f) == getattr(w, f), (w.rid, f)


@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("admit", ["none", "survivors"])
@pytest.mark.parametrize("schedule", ["host", "device"])
def test_engine_matches_reference(schedule, admit, measure):
    # thresholds at which the stream holds both duplicates and novel
    # sets (overlap flags nearly every Zipf set: its small sets share
    # the popular elements)
    t = {"jaccard": 0.6, "cosine": 0.8, "dice": 0.7, "overlap": 0.9}[measure]
    ref, port = engines(corpus_sets(1), threshold=t, measure=measure,
                        admit=admit, micro_batch=5, schedule=schedule)
    queries = stream(2)
    assert_same_results(serve(ref, queries, True), serve(port, queries, True))
    assert port.stats == ref.stats
    assert port.corpus_rows == ref.corpus_rows
    assert port.stats["dups"] > 0
    if admit == "survivors":
        assert port.stats["admitted"] > 0 or measure == "overlap"
        for a, b in zip(ref.encoder.flat.arrays(),
                        port.encoder.flat.arrays()):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("admit", ["none", "survivors"])
@pytest.mark.parametrize("schedule", ["host", "device"])
def test_step_matches_reference_and_drain(schedule, admit):
    kw = dict(threshold=0.4, admit=admit, micro_batch=4, schedule=schedule)
    ref, port = engines(corpus_sets(3), **kw)
    queries = stream(4, n=13)
    by_step = serve(port, queries, False)
    assert_same_results(serve(ref, queries, False), by_step)
    assert port.stats == ref.stats
    # drain pops batch k+1 before batch k's finalize reads the queue
    # depth, so only the batch stats differ from step's
    _, again = engines(corpus_sets(3), **kw)
    assert_same_results(by_step, serve(again, queries, True), FIELDS[:-1])


def test_admission_catches_intra_and_cross_batch_duplicates():
    d = np.asarray([31, 33, 35, 37, 39], np.int32)  # far from the corpus
    for micro_batch in (8, 1):
        ref, port = engines(corpus_sets(5), threshold=0.9,
                            admit="survivors", micro_batch=micro_batch,
                            schedule="device")
        got = serve(port, [d, d], True)
        assert_same_results(serve(ref, [d, d], True), got)
        assert got[0].admitted and not got[0].is_dup
        assert got[1].is_dup and got[1].matches == (got[0].corpus_id,)
        assert port.stats["intra_batch_dups"] == (micro_batch == 8)


def test_empty_corpus_start_and_results_queue():
    seen = []
    port = DedupServeEngine(universe=UNI, threshold=0.8, admit="survivors",
                            device="cpu", on_result=seen.append)
    ref = RefEngine(universe=UNI, threshold=0.8, admit="survivors")
    a = np.asarray([1, 2, 3], np.int32)
    got = serve(port, [a, a, a[:2]], True)
    assert_same_results(serve(ref, [a, a, a[:2]], True), got)
    assert [r.rid for r in seen] == [0, 1, 2]
    assert [r.rid for r in port.results()] == [0, 1, 2]
    assert port.results() == []
    assert all(r.latency_s >= 0 for r in got)
    assert port.corpus_rows == ref.corpus_rows == 2


def test_engine_errors():
    eng = DedupServeEngine(universe=UNI, device="cpu")
    assert eng.step() == [] and eng.drain() == []
    with pytest.raises(ValueError, match="1-D"):
        eng.submit(np.zeros((2, 2), np.int32))
    with pytest.raises(ValueError, match="admit mode"):
        DedupServeEngine(universe=UNI, admit="everything", device="cpu")
    eng.submit([1, 2])
    eng.schedule = "planned"
    with pytest.raises(ValueError, match="unknown walk schedule"):
        eng.step()


def test_default_device_is_the_gpu(monkeypatch):
    """No ``device=``: the GPU, or a named error — never the CPU."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailableError):
        DedupServeEngine(universe=UNI)


@pytest.mark.parametrize("shingle", [1, 3])
def test_docs_to_sets_and_submit_docs_match_reference(shingle):
    rng = np.random.default_rng(11)
    docs = rng.integers(0, UNI, size=(6, 9))
    for universe in (None, UNI):
        want = ref_docs_to_sets(docs, shingle, universe=universe)
        got = docs_to_sets(docs, shingle, universe=universe)
        assert got.universe == want.universe
        for a, b in zip(want.sets, got.sets, strict=True):
            np.testing.assert_array_equal(a, b)
    ref, port = engines(corpus_sets(9), threshold=0.5)
    assert port.submit_docs(docs) == ref.submit_docs(docs)
    assert_same_results(ref.drain(), port.drain())


def test_similarity_matches_reference():
    rng = np.random.default_rng(12)
    for _ in range(30):
        a, b = zipf_set(rng), zipf_set(rng)
        for m in MEASURES:
            assert similarity(a, b, m) == ref_similarity(a, b, m)


@pytest.mark.parametrize("admit", [True, False])
def test_filter_stream_matches_reference(admit):
    rng = np.random.default_rng(13)
    docs = [rng.integers(0, UNI, size=(5, 6)) for _ in range(3)]
    docs[1][2] = docs[0][1]  # a duplicate inside the stream
    corpus = corpus_sets(14)
    ref = RefPipeline(RefCollection.from_ragged(corpus, universe=UNI),
                      threshold=0.6)
    port = DedupPipeline(SetCollection.from_ragged(corpus, universe=UNI),
                         threshold=0.6, device="cpu")
    want, st_w = ref.filter_stream(docs, admit=admit)
    got, st_g = port.filter_stream(docs, admit=admit)
    for a, b in zip(want, got, strict=True):
        np.testing.assert_array_equal(a, b)
    assert st_g == st_w == port.stats
