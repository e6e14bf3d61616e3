"""Training-data pipeline with the join as a dedup stage.

The port of the JAX package's ``data/pipeline.py``. ``DedupPipeline``
drops every incoming document whose token set clears the threshold
against a curated corpus. ``filter_stream`` routes doc batches through
the dedup serve engine with admission, so later docs — duplicates
within the stream included — are judged against the survivors too.
``filter_batch`` joins against the static corpus through the MapReduce
driver (``mr_cf_rs_join``: its loop path on ``device``, or its
multi-device path on ``mesh``, a ``launch.mesh.Mesh`` with ``n_shards``
slots), so two identical new docs in one batch both survive.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.distributed import mr_cf_rs_join
from ..core.sets import SetCollection
from .synth import docs_to_sets

__all__ = ["DedupPipeline"]


@dataclasses.dataclass
class DedupPipeline:
    curated: SetCollection         # S: the corpus we must not duplicate
    threshold: float = 0.8
    n_shards: int = 8
    shingle: int = 1
    method: str = "popcount"
    measure: str = "jaccard"       # cosine/dice/overlap too
    mesh: object = None            # launch.mesh.Mesh: multi-device path
    device: object = None          # None: the first GPU (or mesh slot)

    stats: dict = dataclasses.field(default_factory=dict)

    def filter_batch(self, docs: np.ndarray) -> tuple[np.ndarray, dict]:
        """docs (N, L) int tokens -> (surviving docs, stats)."""
        R = docs_to_sets(docs, self.shingle, universe=self.curated.universe)
        stats: dict = {}
        pairs = mr_cf_rs_join(R, self.curated, self.threshold, self.n_shards,
                              method=self.method, mesh=self.mesh, stats=stats,
                              measure=self.measure, device=self.device)
        dup_rows = {r for (r, _) in pairs}
        keep = np.asarray([i for i in range(len(docs)) if i not in dup_rows],
                          dtype=np.int64)
        stats["n_in"] = len(docs)
        stats["n_dropped"] = len(docs) - len(keep)
        self.stats = stats
        return docs[keep], stats

    def filter_stream(self, doc_batches,
                      admit: bool = True) -> tuple[list[np.ndarray], dict]:
        """Stream doc batches through the dedup serve engine.

        Survivors are (by default) admitted into the corpus as they pass,
        so later docs — including duplicates *within the stream* — are
        judged against them. Returns (surviving docs per input batch,
        engine stats).
        """
        from ..serve.dedup import DedupServeEngine

        universe = (self.curated.universe * 8 if self.shingle > 1
                    else self.curated.universe)  # docs_to_sets' shingles
        engine = DedupServeEngine(
            self.curated, universe=universe, threshold=self.threshold,
            measure=self.measure, admit="survivors" if admit else "none",
            device=self.device)
        kept: list[np.ndarray] = []
        for docs in doc_batches:
            docs = np.asarray(docs)
            rids = engine.submit_docs(docs, self.shingle)
            by_rid = {r.rid: r for r in engine.drain()}
            keep = np.asarray(
                [i for i, rid in enumerate(rids) if not by_rid[rid].is_dup],
                dtype=np.int64)
            kept.append(docs[keep])
        stats = dict(engine.stats)
        stats["n_in"] = sum(len(b) for b in kept) + stats["dups"]
        stats["n_dropped"] = stats["dups"]
        self.stats = stats
        return kept, stats
