"""Front door of the PyTorch port: ``repro_torch.join(R, S, threshold)``.

The counterpart of the JAX package's ``repro.join``, with the same
arguments, the same :class:`JoinResult` and the same stats keys, plus
``device=``: the join runs on the first CUDA device unless the caller
passes ``device="cpu"``, and raises
:class:`~repro_torch.errors.DeviceUnavailableError` when no GPU is
present and the CPU was not asked for.

The port runs both drivers with every method of the reference's:
``'auto'`` (the default), ``'popcount'``, ``'onehot'``,
``'kernel_bitmap'``, ``'kernel_onehot'``, ``'lfvt'`` and ``'lfvt_ref'``;
the single-device driver by default, the MapReduce driver with
``n_shards=`` (its loop path) or ``mesh=`` (its multi-device path, a
:class:`~repro_torch.launch.mesh.Mesh`), each with the resilience kwargs
(``fault_plan=``/``checkpoint_dir=``/``REPRO_FAULT``).

Inputs may be :class:`~repro_torch.core.sets.SetCollection` instances or
plain sequences of integer element arrays (coerced with ``np.unique``,
ids ``0..n-1``, universe inferred from the max element unless given).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Mapping

import numpy as np

from .core.device import resolve_device
from .core.distributed import mr_cf_rs_join
from .core.planner import JoinPlan, JoinStats, PlannerError, build_plan
from .core.sets import SetCollection
from .core.tile_join import cf_rs_join_device
from .launch.mesh import check_mesh, join_axis

__all__ = ["join", "JoinResult", "as_collection"]


def as_collection(sets, universe: int | None = None) -> SetCollection:
    """Coerce a front-door input into a :class:`SetCollection`.

    Passes ``SetCollection`` through untouched; otherwise treats ``sets``
    as an iterable of integer element arrays (deduped + sorted via
    ``np.unique``), ids ``0..n-1`` and ``universe = max element + 1``
    unless given explicitly.
    """
    if isinstance(sets, SetCollection):
        return sets
    arrs = [np.unique(np.asarray(s, dtype=np.int64)).astype(np.int32)
            for s in sets]
    if universe is None:
        universe = int(max((int(a[-1]) for a in arrs if len(a)),
                           default=0)) + 1
    return SetCollection(arrs, int(universe),
                         np.arange(len(arrs), dtype=np.int32))


@dataclasses.dataclass(frozen=True)
class JoinResult:
    """What ``repro_torch.join`` returns.

    ``pairs`` is the exact result set ``{(r_id, s_id)}`` regardless of
    ``emit``; ``mask`` is the dense ``(|R|, |S|)`` bool matrix (input row
    order) only for ``emit='mask'``. ``stats`` wraps the driver's stats
    mapping (``.to_dict()`` is byte-compatible with the raw dict);
    ``plan`` is the resolved planner decision.
    """

    pairs: frozenset
    mask: np.ndarray | None
    stats: JoinStats
    plan: JoinPlan

    def sorted_pairs(self) -> list[tuple[int, int]]:
        return sorted(self.pairs)

    def __len__(self) -> int:
        return len(self.pairs)

    def __iter__(self):
        return iter(self.pairs)


def _dense_mask(pairs: Iterable[tuple[int, int]], R: SetCollection,
                S: SetCollection) -> np.ndarray:
    r_row = {int(i): k for k, i in enumerate(R.ids)}
    s_row = {int(i): k for k, i in enumerate(S.ids)}
    mask = np.zeros((len(R), len(S)), dtype=bool)
    for a, b in pairs:
        mask[r_row[int(a)], s_row[int(b)]] = True
    return mask


def join(R, S, threshold: float, *, measure: str = "jaccard",
         method: str = "auto", emit: str = "pairs",
         n_shards: int | None = None, strategy: str = "load_aware",
         mesh=None, axis: str | None = None, pad: str | None = None,
         schedule: str | None = None, pair_capacity: int | None = None,
         r_block: int | None = None, row_tile: int | None = None,
         double_buffer: bool | None = None, fault_plan=None,
         checkpoint_dir: str | None = None,
         stats: dict | None = None, device=None) -> JoinResult:
    """Candidate-free R-S set similarity join (paper front door).

    threshold: similarity threshold ``t`` for ``measure`` ('jaccard' |
        'cosine' | 'dice' | 'overlap').
    method: 'auto' (default) — the cost model probes the inputs and
        picks the cheapest rep family (DESIGN.md §14). Or force
        'popcount' | 'onehot' | 'kernel_bitmap' | 'kernel_onehot' |
        'lfvt' | 'lfvt_ref' (see ``cf_rs_join_device``).
    emit: 'pairs' returns the compacted pair set only; 'mask' also
        materializes the dense ``(|R|, |S|)`` bool matrix in
        ``result.mask``.
    n_shards / strategy / mesh / axis / pad / schedule: MapReduce
        controls — any of them selects ``mr_cf_rs_join`` (``n_shards``
        defaults to the mesh axis size when only ``mesh`` is given);
        all None runs the single-device tile driver. Without ``mesh``
        the shards run one after another on the device; with it, shard
        ``k`` runs on slot ``k`` of the mesh.
    r_block / row_tile / pair_capacity / double_buffer: device tuning
        overrides folded into the :class:`JoinPlan`.
    fault_plan / checkpoint_dir: resilience ladder + task ledger
        (DESIGN.md §12), forwarded verbatim.
    stats: optional dict to share the raw driver stats mapping with the
        caller (the same object wrapped by ``result.stats``).
    device: 'cuda' (default, the first GPU) or 'cpu'; with a mesh, the
        mesh's first slot by default.

    Every kwarg combination is validated up front through the planner's
    lattice; invalid ones raise
    :class:`~repro_torch.core.planner.PlannerError`.
    """
    if mesh is not None:
        check_mesh(mesh)
        if device is None:
            device = mesh.devices[0]
    device = resolve_device(device)
    R = as_collection(R)
    S = as_collection(S)
    mr = n_shards is not None or mesh is not None
    if mr and n_shards is None:
        n_shards = mesh.shape.get(join_axis(mesh, axis))
    if not mr:
        for name, val in (("strategy", strategy != "load_aware"),
                          ("pad", pad is not None),
                          ("schedule", schedule is not None)):
            if val:
                raise PlannerError(
                    f"{name} applies to the MapReduce driver; pass "
                    f"n_shards= (or mesh=) to select it")
    elif r_block is not None or row_tile is not None:
        raise PlannerError(
            "r_block/row_tile tune the single-device tile driver; drop "
            "n_shards/mesh to select it")

    raw: dict[str, Any] = stats if stats is not None else {}
    if not mr:
        plan = build_plan(R, S, threshold, driver="device", method=method,
                          measure=measure, emit=emit, r_block=r_block,
                          row_tile=row_tile, pair_capacity=pair_capacity,
                          double_buffer=double_buffer)
        pairs = cf_rs_join_device(R, S, threshold, stats=raw, emit=emit,
                                  pair_capacity=pair_capacity,
                                  measure=measure, fault_plan=fault_plan,
                                  checkpoint_dir=checkpoint_dir, plan=plan,
                                  device=device)
    else:
        pairs = mr_cf_rs_join(R, S, threshold, n_shards, strategy=strategy,
                              method=method, mesh=mesh, axis=axis,
                              stats=raw, emit=emit, pad=pad,
                              pair_capacity=pair_capacity,
                              measure=measure, fault_plan=fault_plan,
                              checkpoint_dir=checkpoint_dir,
                              schedule=schedule, device=device)
    plan_dict: Mapping[str, Any] | None = raw.get("plan")
    plan = (JoinPlan.from_dict(plan_dict) if plan_dict is not None
            else build_plan(driver="mr" if mr else "device", method=method,
                            measure=measure, emit=emit))
    mask = _dense_mask(pairs, R, S) if emit == "mask" else None
    return JoinResult(pairs=frozenset(pairs), mask=mask,
                      stats=JoinStats.from_dict(raw), plan=plan)
