"""Always-on dedup serving: the join as a continuous-batch service.

The port of the JAX package's ``serve/dedup.py``. The LFVT is built once
and queried many times: a device-resident FlatLFVT corpus answers "is
this doc a near-duplicate?" for a request stream.

  * ``submit`` enqueues a request (one element set) and returns a
    request id at once;
  * ``step`` pops up to ``micro_batch`` requests, pads them on the host
    into one rectangular R block (lane width rounded up to a power-of-two
    multiple of ``serve_lane_grain``), uploads it once and dispatches it
    through ``ops.lfvt_walk_join_pairs_dispatch`` — the host-planned walk
    (K1, ``schedule="host"``) or the device-planned one (K6,
    ``schedule="device"``) — over the ``IncrementalLFVT`` view, whose
    device upload is shared across batches until an append drops it;
  * results are emitted per request: an optional ``on_result`` callback
    plus a pollable ``results()`` queue, each :class:`DedupResult`
    carrying its latency and its micro-batch's walk counters;
  * ``admit="survivors"`` feeds every non-duplicate doc straight back
    through the incremental encoder, so the corpus grows while it
    serves. Admission is sequential within a batch, with a host
    similarity check against the batch's earlier admissions, so two
    identical new docs in one stream do not both survive.

``drain`` double-buffers when ``admit="none"``: batch k+1 is dispatched
before batch k's finalize copies its counts back; one stream keeps the
order. Admission forces sequential batches, since batch k+1's walk must
see batch k's appends.
"""
from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np

from ..core.config import global_config
from ..core.device import resolve_device, upload
from ..core.lfvt_flat import IncrementalLFVT
from ..core.sets import SetCollection, similarity
from ..kernels import ops

__all__ = ["DedupResult", "DedupServeEngine"]


@dataclasses.dataclass(frozen=True)
class DedupResult:
    """Outcome of one served request (emitted per request)."""

    rid: int               # id handed back by submit()
    is_dup: bool           # matched the corpus (or an earlier admission)
    matches: tuple         # external corpus ids that cleared the threshold
    admitted: bool         # admit mode grew the corpus with this doc
    corpus_id: int         # id assigned on admission, -1 otherwise
    latency_s: float       # submit -> emission
    stats: dict            # its micro-batch's counters (walk_steps, ...)


class DedupServeEngine:
    """Micro-batched near-dup join service over a growing FlatLFVT.

    ``device`` is where the walk runs: None means the first CUDA device
    (``DeviceUnavailableError`` without one); ``"cpu"`` runs the plain
    PyTorch versions of the kernels.
    """

    def __init__(self, corpus: SetCollection | None = None, *,
                 universe: int | None = None, threshold: float = 0.8,
                 measure: str = "jaccard", admit: str = "none",
                 micro_batch: int | None = None, device=None,
                 schedule: str = "host", on_result=None):
        if admit not in ("none", "survivors"):
            raise ValueError(f"unknown admit mode {admit!r} "
                             "(expected 'none' or 'survivors')")
        self.device = resolve_device(device)
        self.encoder = IncrementalLFVT(corpus, universe=universe)
        self.threshold = float(threshold)
        self.measure = measure
        self.admit = admit
        self.micro_batch = int(micro_batch or global_config.serve_micro_batch)
        self.schedule = schedule
        self.on_result = on_result
        self._queue: collections.deque = collections.deque()
        self._emitted: collections.deque = collections.deque()
        self._next_rid = 0
        self.stats = {"requests": 0, "batches": 0, "dups": 0, "admitted": 0,
                      "intra_batch_dups": 0, "pair_count": 0,
                      "walk_steps": 0, "early_stops": 0, "live_tiles": 0}

    # -------------------------------------------------------------- #
    @property
    def corpus_rows(self) -> int:
        """Live corpus size (base + admissions)."""
        return self.encoder.n_live

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    def submit(self, elements) -> int:
        """Enqueue one element set; returns its request id."""
        a = np.asarray(elements, dtype=np.int32)
        if a.ndim != 1:
            raise ValueError(f"request must be a 1-D element list, "
                             f"got shape {a.shape}")
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append((rid, np.unique(a), time.perf_counter()))
        self.stats["requests"] += 1
        return rid

    def submit_docs(self, docs: np.ndarray, shingle: int = 1) -> list[int]:
        """Enqueue token-sequence docs (``data.synth.docs_to_sets``)."""
        from ..data.synth import docs_to_sets
        R = docs_to_sets(np.asarray(docs), shingle,
                         universe=self.encoder.universe)
        return [self.submit(s) for s in R.sets]

    def results(self) -> list[DedupResult]:
        """Pop everything emitted since the last poll."""
        out = list(self._emitted)
        self._emitted.clear()
        return out

    # -------------------------------------------------------------- #
    def _dispatch(self, batch):
        """Pad one micro-batch of requests on the host, upload it once and
        launch the walk (no wait for the device happens here)."""
        enc = self.encoder
        flat = enc.flat
        B = self.micro_batch
        grain = int(global_config.serve_lane_grain)
        lr = max(grain, max((len(a) for _, a, _ in batch), default=1))
        lane = grain
        while lane < lr:  # pow-2 lane width
            lane <<= 1
        r_padded = np.full((B, lane), -1, np.int32)
        sizes = np.zeros(B, np.int64)
        for i, (_, a, _) in enumerate(batch):
            r_padded[i, :len(a)] = a
            sizes[i] = len(a)
        lo, hi = enc.window_bounds(sizes, self.threshold, self.measure)
        pending = ops.lfvt_walk_join_pairs_dispatch(
            flat, upload(r_padded, self.device), sizes, lo, hi,
            self.threshold, measure=self.measure, schedule=self.schedule)
        return pending, flat

    def _finalize(self, batch, pending, flat) -> list[DedupResult]:
        """Sync one dispatched batch, run admission, emit results."""
        batch_stats: dict = {}
        pairs, _ = ops.join_pairs_finalize(pending, stats=batch_stats)
        pairs = pairs.cpu().numpy()
        pairs = pairs[pairs[:, 0] >= 0]
        matches: list[list[int]] = [[] for _ in batch]
        for r, c in pairs:
            if r < len(batch):
                matches[r].append(int(flat.s_ids[c]))

        admitted: dict[int, int] = {}  # batch idx -> assigned corpus id
        if self.admit == "survivors":
            keep: list[int] = []
            intra: dict[int, int] = {}  # dup idx -> surviving batch idx
            for i, (_, a, _) in enumerate(batch):
                if matches[i]:
                    continue
                hit = next(
                    (j for j in keep
                     if similarity(a, batch[j][1], self.measure)
                     >= self.threshold), None)
                if hit is None:
                    keep.append(i)
                else:
                    intra[i] = hit
                    self.stats["intra_batch_dups"] += 1
            if keep:
                new_ids = self.encoder.append([batch[i][1] for i in keep])
                admitted = {i: int(new_ids[k]) for k, i in enumerate(keep)}
            for i, j in intra.items():
                matches[i].append(admitted[j])

        now = time.perf_counter()
        batch_stats.update(batch_fill=len(batch) / self.micro_batch,
                           queue_depth=len(self._queue),
                           corpus_rows=self.encoder.n_live)
        self.stats["batches"] += 1
        for key in ("pair_count", "walk_steps", "early_stops", "live_tiles"):
            self.stats[key] += int(batch_stats.get(key, 0))
        out = []
        for i, (rid, _, t_enq) in enumerate(batch):
            is_dup = bool(matches[i])
            self.stats["dups"] += int(is_dup)
            self.stats["admitted"] += int(i in admitted)
            res = DedupResult(
                rid=rid, is_dup=is_dup,
                matches=tuple(sorted(set(matches[i]))),
                admitted=i in admitted, corpus_id=admitted.get(i, -1),
                latency_s=now - t_enq, stats=batch_stats)
            out.append(res)
            self._emitted.append(res)
            if self.on_result is not None:
                self.on_result(res)
        return out

    def _pop_batch(self):
        take = min(self.micro_batch, len(self._queue))
        return [self._queue.popleft() for _ in range(take)]

    def step(self) -> list[DedupResult]:
        """Serve one micro-batch from the queue ([] when idle)."""
        if not self._queue:
            return []
        batch = self._pop_batch()
        return self._finalize(batch, *self._dispatch(batch))

    def drain(self) -> list[DedupResult]:
        """Serve until the queue is empty. With ``admit="none"`` the
        corpus is static, so batch k+1 is dispatched before batch k's
        finalize (double-buffered); admission forces sequential steps
        because the next walk must see this batch's appends."""
        served: list[DedupResult] = []
        if self.admit != "none":
            while self._queue:
                served.extend(self.step())
            return served
        in_flight = None
        while self._queue or in_flight is not None:
            nxt = None
            if self._queue:
                batch = self._pop_batch()
                nxt = (batch, *self._dispatch(batch))
            if in_flight is not None:
                served.extend(self._finalize(*in_flight))
            in_flight = nxt
        return served
