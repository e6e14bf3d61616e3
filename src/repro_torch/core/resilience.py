"""Resilience layer for the MR join drivers (DESIGN.md §12).

The port of the JAX package's ``core/resilience.py`` (numpy only), with
the same grammar, counters, task ids and on-disk checkpoint format, so a
checkpoint directory written by either package resumes in the other.

The paper's MR-CF-RS-Join assumes every map/reduce task completes; a
production join over millions of sets cannot. This module is the
fault-tolerance substrate threaded through ``mr_cf_rs_join`` and
``cf_rs_join_device``:

  ledger      ``TaskLedger`` — deterministic shard/bucket task ids with
              per-task completion records and an optional on-disk
              checkpoint (``checkpoint_dir=``): each completed task's
              compacted pair slice + stat deltas land in one atomic
              ``task_<sha1>.npz``, guarded by a ``manifest.json`` run
              signature (join params + collection digests). A resumed
              call skips completed tasks and is bit-identical to an
              uninterrupted run.
  faults      ``FaultPlan`` — a deterministic, seeded fault-injection
              harness (``fault_plan=`` / ``REPRO_FAULT``). Named
              failures fire at instrumented sites; counters are keyed
              per (site, kind, task) so runs replay exactly.
  retry       ``RetryPolicy`` — bounded attempts with capped
              exponential backoff. Deterministic: backoff seconds are
              computed and *recorded*, never slept, unless
              ``global_config.retry_sleep`` is on.
  ladder      ``Resilience.run`` — a graceful-degradation ladder: each
              task is a list of rungs (e.g. kernel walk -> whole-block
              walk -> host oracle). Transient faults retry the current
              rung; persistent faults, simulated OOM and pair-capacity
              overflow degrade to the next rung. Every hop is recorded
              in ``stats["degradations"]`` — the path changes, the
              result never does. Any other exception (a failed kernel
              build, a CUDA launch error) propagates: the ladder never
              hides the device.

Fault-plan grammar (semicolon-separated rules)::

    site:kind[:count]

sites  device_upload | walk_dispatch | compact | regrow | shard_map |
       checkpoint_write | flat_tables
kinds  transient  — raise ``TransientFault`` on the first ``count``
                    (default 1) hits of the site per task
       persistent — raise ``PersistentFault`` on every hit
       oom        — raise ``SimulatedOOM``, first ``count`` hits/task
       storm      — raise ``PairCapacityError`` (a pair-cap overflow
                    storm), first ``count`` hits per task
       corrupt    — deterministically corrupt the ``FlatLFVT`` passing
                    through the site (first ``count`` hits per task);
                    detected by ``FlatLFVT.validate`` and retried
       kill       — ``SIGKILL`` the process on the ``count``-th hit of
                    the site (global counter): the kill-and-resume
                    harness for the checkpoint path

The hooks (``fault_point`` / ``corrupt_point``) are module-level and
cost one global ``None`` check when no plan is active.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import signal
import time

import numpy as np

from .config import global_config

__all__ = [
    "ResilienceError", "TransientFault", "PersistentFault", "SimulatedOOM",
    "ShardFailedError", "CheckpointMismatchError", "PairCapacityError",
    "FaultPlan", "FaultInjector", "RetryPolicy", "TaskLedger", "Resilience",
    "FAULT_SITES", "FAULT_KINDS", "fault_point", "corrupt_point", "active",
    "build_resilience", "collection_digest", "resilience_stats",
]


# ---------------------------------------------------------------------- #
# error taxonomy
# ---------------------------------------------------------------------- #
class ResilienceError(RuntimeError):
    """Base class of every injected/derived resilience failure."""


class TransientFault(ResilienceError):
    """A failure that is expected to clear on retry (network blip,
    preempted device, corrupted shipment re-read from source)."""


class PersistentFault(ResilienceError):
    """A failure retrying cannot fix — the ladder degrades instead."""


class SimulatedOOM(ResilienceError):
    """Injected device out-of-memory; degrades to a split/smaller rung."""


class ShardFailedError(ResilienceError):
    """Every rung of a task's degradation ladder failed."""


class CheckpointMismatchError(ValueError):
    """checkpoint_dir holds a manifest for a *different* run (inputs or
    join parameters changed); resuming would splice incompatible
    results, so the driver refuses early."""


class PairCapacityError(ValueError):
    """The power-of-two regrow protocol hit
    ``global_config.pair_cap_ceiling`` — the request would allocate past
    the configured pair-buffer limit (and, unguarded, could overflow
    int32 pair counts downstream)."""


FAULT_SITES = ("device_upload", "walk_dispatch", "compact", "regrow",
               "shard_map", "checkpoint_write", "flat_tables")
FAULT_KINDS = ("transient", "persistent", "oom", "storm", "corrupt", "kill")


# ---------------------------------------------------------------------- #
# fault plan + injector
# ---------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class FaultRule:
    site: str
    kind: str
    count: int = 1


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Parsed, validated fault plan. An *empty* plan (no rules) is still
    an active plan: it forces the drivers onto the resilience-managed
    task path without injecting anything — the fault-free overhead
    configuration the benchmark times."""

    rules: tuple[FaultRule, ...] = ()
    seed: int = 0

    @classmethod
    def parse(cls, spec: str, seed: int = 0) -> "FaultPlan":
        rules = []
        for part in (spec or "").split(";"):
            part = part.strip()
            if not part:
                continue
            bits = part.split(":")
            if len(bits) not in (2, 3):
                raise ValueError(
                    f"fault rule {part!r}: expected site:kind[:count]")
            site, kind = bits[0], bits[1]
            if site not in FAULT_SITES:
                raise ValueError(
                    f"unknown fault site {site!r} (one of {FAULT_SITES})")
            if kind not in FAULT_KINDS:
                raise ValueError(
                    f"unknown fault kind {kind!r} (one of {FAULT_KINDS})")
            count = int(bits[2]) if len(bits) == 3 else 1
            if count < 1:
                raise ValueError(f"fault rule {part!r}: count must be >= 1")
            rules.append(FaultRule(site, kind, count))
        return cls(tuple(rules), seed)

    def rules_for(self, site: str):
        return [r for r in self.rules if r.site == site]


def _corrupt_flat(flat, seed: int):
    """Deterministically corrupt one structural invariant of a FlatLFVT.

    Returns a *copy* (the memoized original is write-protected and must
    survive for the retry to re-read a clean table). The corruption is
    always detectable by ``FlatLFVT.validate``.
    """
    fields = {
        f.name: np.array(getattr(flat, f.name))
        for f in dataclasses.fields(flat)
        if isinstance(getattr(flat, f.name), np.ndarray)}
    rng = np.random.default_rng(seed)
    T = len(fields["seq_row"])
    E = len(fields["entry_elem"])
    n = len(fields["s_sizes"])
    if T:  # hop chain escapes the sequence table
        fields["seq_next"][int(rng.integers(T))] = np.int32(T + 3)
    elif E:  # negative walk length
        fields["entry_len"][int(rng.integers(E))] = np.int32(-1)
    elif n:  # negative set size
        fields["s_sizes"][int(rng.integers(n))] = np.int32(-1)
    else:  # nothing to corrupt in an empty tree
        return flat
    return dataclasses.replace(flat, _device={}, **fields)


class FaultInjector:
    """Executes a ``FaultPlan``: deterministic per-(site, kind, task)
    counters decide which hits of a site fire."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.counters: dict[tuple, int] = {}
        self.injected = 0

    def _bump(self, site: str, kind: str, task) -> int:
        key = (site, kind, task)
        c = self.counters.get(key, 0) + 1
        self.counters[key] = c
        return c

    def hit(self, site: str, task: str | None) -> None:
        for rule in self.plan.rules_for(site):
            if rule.kind == "kill":
                # global counter: "the N-th checkpoint write kills us"
                if self._bump(site, "kill", None) == rule.count:
                    os.kill(os.getpid(), signal.SIGKILL)
            elif rule.kind == "persistent":
                self.injected += 1
                raise PersistentFault(f"injected persistent fault at {site}"
                                      f" (task {task})")
            elif rule.kind in ("transient", "oom", "storm"):
                if self._bump(site, rule.kind, task) <= rule.count:
                    self.injected += 1
                    if rule.kind == "transient":
                        raise TransientFault(
                            f"injected transient fault at {site}"
                            f" (task {task})")
                    if rule.kind == "oom":
                        raise SimulatedOOM(
                            f"injected OOM at {site} (task {task})")
                    raise PairCapacityError(
                        f"injected pair-cap overflow storm at {site}"
                        f" (task {task})")

    def maybe_corrupt(self, site: str, task: str | None, value):
        for rule in self.plan.rules_for(site):
            if rule.kind != "corrupt":
                continue
            c = self._bump(site, "corrupt", task)
            if c <= rule.count:
                self.injected += 1
                return _corrupt_flat(value, self.plan.seed + c)
        return value


# ---------------------------------------------------------------------- #
# module-level hooks: one global check when inactive (hot-path budget)
# ---------------------------------------------------------------------- #
_INJECTOR: FaultInjector | None = None
_TASK: str | None = None


def fault_point(site: str) -> None:
    """Instrumented site: no-op unless a resilience task is executing."""
    inj = _INJECTOR
    if inj is not None:
        inj.hit(site, _TASK)


def corrupt_point(site: str, value):
    """Corruption-capable site: returns ``value`` (possibly a corrupted
    copy when an active plan says so)."""
    inj = _INJECTOR
    if inj is None:
        return value
    return inj.maybe_corrupt(site, _TASK, value)


def active() -> bool:
    """True while a resilience-managed task is executing."""
    return _INJECTOR is not None


def checked_flat(flat):
    """The ``flat_tables`` corruption site for FlatLFVT shipments.

    Passes ``flat`` through the injector; if a corrupted copy comes
    back, detects it via ``FlatLFVT.validate`` and raises
    :class:`TransientFault` — the retry re-reads the clean memoized
    table (whose injection counter has advanced past the rule's count).
    Returns the original table; no-op outside a resilience task.
    """
    inj = _INJECTOR
    if inj is None:
        return flat
    out = inj.maybe_corrupt("flat_tables", _TASK, flat)
    if out is not flat:
        from .lfvt_flat import FlatLFVTError  # deferred: stays a leaf
        try:
            out.validate()
        except FlatLFVTError as e:
            raise TransientFault(
                f"corrupt flat tables detected: {e}") from e
    return flat


# ---------------------------------------------------------------------- #
# retry policy
# ---------------------------------------------------------------------- #
@dataclasses.dataclass
class RetryPolicy:
    """Bounded retries with capped exponential backoff.

    Deterministic by default: ``pause`` computes and returns the backoff
    seconds without sleeping (the driver folds them into
    ``stats["backoff_total"]``); real sleeps only with ``sleep=True``
    (``global_config.retry_sleep``).
    """

    max_attempts: int = 3
    backoff_base: float = 0.05
    backoff_cap: float = 1.0
    sleep: bool = False

    @classmethod
    def from_config(cls) -> "RetryPolicy":
        return cls(max_attempts=int(global_config.retry_max_attempts),
                   backoff_base=float(global_config.retry_backoff_base),
                   backoff_cap=float(global_config.retry_backoff_cap),
                   sleep=bool(global_config.retry_sleep))

    def backoff(self, attempt: int) -> float:
        """Backoff after the ``attempt``-th failure (1-based)."""
        return min(self.backoff_base * (2.0 ** (attempt - 1)),
                   self.backoff_cap)

    def pause(self, attempt: int) -> float:
        d = self.backoff(attempt)
        if self.sleep:  # pragma: no cover - never under test
            time.sleep(d)
        return d


# ---------------------------------------------------------------------- #
# task ledger + checkpoint
# ---------------------------------------------------------------------- #
def collection_digest(C) -> str:
    """Content digest of a ``SetCollection`` (ids, sizes, elements,
    universe) — the checkpoint manifest's input identity."""
    h = hashlib.sha1()
    h.update(np.int64(C.universe).tobytes())
    h.update(np.asarray(C.ids, np.int64).tobytes())
    h.update(np.asarray(C.sizes(), np.int64).tobytes())
    for s in C.sets:
        h.update(np.asarray(s, np.int32).tobytes())
    return h.hexdigest()


class TaskLedger:
    """Per-task completion records; optionally persisted per task.

    On-disk layout (``checkpoint_dir``)::

        manifest.json           run signature (join params + digests)
        task_<sha1(id)>.npz     task=<id>, pairs=(n, 2) int64 global id
                                pairs (sorted), deltas=<json stat deltas>

    Writes are atomic (tmp + ``os.replace``), so a mid-write kill never
    leaves a half-record; ``fault_point("checkpoint_write")`` fires
    before the write — the kill/transient injection point.
    """

    def __init__(self, checkpoint_dir: str | None = None):
        self.dir = checkpoint_dir
        self.records: dict[str, tuple[np.ndarray, dict]] = {}

    def _path(self, task_id: str) -> str:
        digest = hashlib.sha1(task_id.encode()).hexdigest()[:20]
        return os.path.join(self.dir, f"task_{digest}.npz")

    def open_run(self, signature: dict) -> None:
        """Create or validate the checkpoint manifest for this run."""
        if not self.dir:
            return
        os.makedirs(self.dir, exist_ok=True)
        man = os.path.join(self.dir, "manifest.json")
        if os.path.exists(man):
            with open(man) as fh:
                old = json.load(fh)
            if old != signature:
                diff = sorted(k for k in set(old) | set(signature)
                              if old.get(k) != signature.get(k))
                raise CheckpointMismatchError(
                    f"checkpoint_dir {self.dir!r} belongs to a different "
                    f"run (mismatched: {diff}); use a fresh directory")
        else:
            tmp = man + ".tmp"
            with open(tmp, "w") as fh:
                json.dump(signature, fh, indent=2, sort_keys=True)
            os.replace(tmp, man)

    def is_done(self, task_id: str) -> bool:
        if task_id in self.records:
            return True
        return bool(self.dir) and os.path.exists(self._path(task_id))

    def load(self, task_id: str) -> tuple[np.ndarray, dict]:
        if task_id not in self.records:
            with np.load(self._path(task_id), allow_pickle=False) as z:
                pairs = np.asarray(z["pairs"], np.int64).reshape(-1, 2)
                deltas = json.loads(str(z["deltas"]))
            self.records[task_id] = (pairs, deltas)
        return self.records[task_id]

    def commit(self, task_id: str, pairs: np.ndarray, deltas: dict) -> None:
        pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
        self.records[task_id] = (pairs, deltas)
        if not self.dir:
            return
        fault_point("checkpoint_write")
        path = self._path(task_id)
        tmp = path + ".tmp"
        with open(tmp, "wb") as fh:
            np.savez(fh, task=np.array(task_id), pairs=pairs,
                     deltas=np.array(json.dumps(deltas)))
        os.replace(tmp, path)


# ---------------------------------------------------------------------- #
# the ladder runner
# ---------------------------------------------------------------------- #
def sorted_pairs(pairs) -> np.ndarray:
    """Canonical (n, 2) int64 form of a pair set (ledger/compare order)."""
    if isinstance(pairs, np.ndarray):
        arr = np.asarray(pairs, np.int64).reshape(-1, 2)
    elif pairs:
        arr = np.array(list(pairs), np.int64).reshape(-1, 2)
    else:
        return np.zeros((0, 2), np.int64)
    return arr[np.lexsort((arr[:, 1], arr[:, 0]))]


class Resilience:
    """Retry + degradation + ledger driver for one join call.

    ``run(task_id, rungs)`` executes the first rung of ``rungs``
    (``[(name, fn), ...]``; ``fn() -> (pairs (n, 2) int64, deltas
    dict)``) under the retry policy, degrading rung by rung on
    persistent failure, and commits the surviving result to the ledger.
    Completed tasks (same ledger / checkpoint dir) are skipped and
    their recorded result returned — the resume path.
    """

    def __init__(self, policy: RetryPolicy, injector: FaultInjector,
                 ledger: TaskLedger):
        self.policy = policy
        self.injector = injector
        self.ledger = ledger
        self.retries = 0
        self.degradations: list[str] = []
        self.tasks_resumed = 0
        self.guardrail_splits = 0
        self.backoff_total = 0.0

    # -- task context ------------------------------------------------- #
    @contextlib.contextmanager
    def _task(self, task_id: str):
        global _INJECTOR, _TASK
        prev = (_INJECTOR, _TASK)
        _INJECTOR, _TASK = self.injector, task_id
        try:
            yield
        finally:
            _INJECTOR, _TASK = prev

    # -- the ladder ---------------------------------------------------- #
    def run(self, task_id: str, rungs) -> tuple[np.ndarray, dict]:
        if self.ledger.is_done(task_id):
            pairs, deltas = self.ledger.load(task_id)
            self.tasks_resumed += 1
            return pairs, deltas
        last: Exception | None = None
        for ri, (rname, fn) in enumerate(rungs):
            attempt = 0
            while attempt < self.policy.max_attempts:
                attempt += 1
                try:
                    with self._task(task_id):
                        pairs, deltas = fn()
                except TransientFault as e:
                    last = e
                    if attempt >= self.policy.max_attempts:
                        break  # transient budget spent: degrade
                    self.retries += 1
                    self.backoff_total += self.policy.pause(attempt)
                    continue
                except (PersistentFault, SimulatedOOM,
                        PairCapacityError) as e:
                    last = e
                    break  # not retryable on this rung: degrade
                deltas = dict(deltas)
                deltas.setdefault("rung", rname)
                self._commit(task_id, pairs, deltas)
                return pairs, deltas
            if ri + 1 < len(rungs):
                self.degradations.append(
                    f"{task_id}:{rname}->{rungs[ri + 1][0]}")
        raise ShardFailedError(
            f"task {task_id}: every degradation rung failed "
            f"({[r[0] for r in rungs]})") from last

    def _commit(self, task_id: str, pairs, deltas: dict) -> None:
        """Ledger commit with its own retry loop; a persistently failing
        checkpoint write degrades to in-memory-only (the result is
        never lost, only its durability)."""
        pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
        attempt = 0
        while True:
            attempt += 1
            try:
                with self._task(task_id):
                    self.ledger.commit(task_id, pairs, deltas)
                return
            except TransientFault:
                if attempt >= self.policy.max_attempts:
                    self._skip_checkpoint(task_id, pairs, deltas)
                    return
                self.retries += 1
                self.backoff_total += self.policy.pause(attempt)
            except PersistentFault:
                self._skip_checkpoint(task_id, pairs, deltas)
                return

    def _skip_checkpoint(self, task_id, pairs, deltas) -> None:
        self.degradations.append(f"{task_id}:checkpoint->memory_only")
        self.ledger.records[task_id] = (pairs, deltas)

    # -- stats --------------------------------------------------------- #
    def stats_view(self) -> dict:
        return {"retries": self.retries,
                "degradations": list(self.degradations),
                "faults_injected": self.injector.injected,
                "tasks_resumed": self.tasks_resumed,
                "guardrail_splits": self.guardrail_splits,
                "backoff_total": self.backoff_total}


def resilience_stats(stats: dict, res: "Resilience | None") -> None:
    """Fold the resilience counters into a driver stats dict (zeros when
    the layer is inactive, so consumers can index unconditionally)."""
    if stats is None:
        return
    base = {"retries": 0, "degradations": [], "faults_injected": 0,
            "tasks_resumed": 0, "guardrail_splits": 0, "backoff_total": 0.0}
    if res is not None:
        base.update(res.stats_view())
    stats.update(base)


def build_resilience(checkpoint_dir: str | None = None,
                     fault_plan=None) -> "Resilience | None":
    """Resolve the drivers' resilience configuration.

    Active iff a checkpoint dir is given, a fault plan is passed
    explicitly (an empty-string plan counts: it forces the managed task
    path without injecting faults), or ``global_config.fault``
    (``REPRO_FAULT``) is non-empty. Returns None when inactive — the
    drivers then run their original streaming paths untouched.
    """
    spec = fault_plan
    if spec is None:
        cfg = getattr(global_config, "fault", "")
        spec = cfg if cfg else None
    if spec is None and checkpoint_dir is None:
        return None
    if isinstance(spec, FaultPlan):
        plan = spec
    else:
        plan = FaultPlan.parse(spec or "",
                               seed=int(global_config.fault_seed))
    return Resilience(RetryPolicy.from_config(), FaultInjector(plan),
                      TaskLedger(checkpoint_dir))
