"""The part of the resilience layer the unmanaged join path touches.

The JAX package's ``core/resilience.py`` runs per-block tasks under a
retry and degradation ladder with checkpoints and fault injection. The
port's first slice keeps only what the plain streaming path calls: the
named capacity error, the instrumented fault sites (no-ops here, with
the reference's site names so a later slice can hang the injector on
them) and the zero resilience counters every driver stats dict
carries. ``fault_plan=`` and ``checkpoint_dir=`` raise
:class:`~repro_torch.errors.NotPortedError` until the ladder is ported.
"""
from __future__ import annotations

from ..errors import NotPortedError

__all__ = ["PairCapacityError", "FAULT_SITES", "fault_point",
           "resilience_stats", "check_unmanaged"]


class PairCapacityError(ValueError):
    """The power-of-two regrow protocol hit
    ``global_config.pair_cap_ceiling`` — the request would allocate past
    the configured pair-buffer limit (and, unguarded, could overflow
    int32 pair counts downstream)."""


FAULT_SITES = ("device_upload", "walk_dispatch", "compact", "regrow",
               "shard_map", "checkpoint_write", "flat_tables")


def fault_point(site: str) -> None:
    """Instrumented site (one of ``FAULT_SITES``); a no-op until fault
    injection is ported."""


def check_unmanaged(fault_plan=None, checkpoint_dir: str | None = None
                    ) -> None:
    """Refuse the managed (resilience) path, which is not ported yet."""
    if fault_plan is not None:
        raise NotPortedError(
            "fault_plan= needs the resilience ladder, which the PyTorch "
            "port does not have yet; drop the kwarg")
    if checkpoint_dir is not None:
        raise NotPortedError(
            "checkpoint_dir= needs the task ledger, which the PyTorch "
            "port does not have yet; drop the kwarg")


def resilience_stats(stats: dict) -> None:
    """Fold the resilience counters into a driver stats dict: the zeros
    of an inactive layer, so consumers can index unconditionally."""
    stats.update({"retries": 0, "degradations": [], "faults_injected": 0,
                  "tasks_resumed": 0, "guardrail_splits": 0,
                  "backoff_total": 0.0})

