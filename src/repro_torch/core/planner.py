"""Adaptive cost-model method dispatch (DESIGN.md §14), a numpy copy of
the JAX package's ``core/planner.py``.

The committed BENCH artifacts prove the method trade-off is real:
bitmap popcount wins small universes, the flat-LFVT walk wins large
ones (82x at U=2^21, BENCH_pr4), one-hot only ever pays on matmul
hardware, and Zipf skew moves the crossover. This module owns the
decision so the caller no longer has to:

  * :func:`probe_features` — a cheap O(m+n+E) host probe of the inputs
    (m, n, universe, density, Zipf head mass, the per-measure Lemma-3.1
    window fraction, and the exact expected walk traffic
    sum_a freq_R(a) * freq_S(a));
  * :func:`score_methods` — a linear cost model per rep family
    (``seconds = fixed + per_byte * bytes_staged + per_unit * work +
    per_tile * row_tiles``) with embedded default coefficients,
    re-scaled per family from whatever ``BENCH_pr*.json`` artifacts are
    present in the working directory (:func:`load_calibration`);
  * :func:`build_plan` — the single kwarg-lattice validator + planner
    front end both drivers call. It emits a frozen :class:`JoinPlan`
    (method, per-shard methods on the MR loop path, block/tile sizes,
    pad mode, walk schedule) that ``cf_rs_join_device`` and
    ``mr_cf_rs_join(method="auto")`` consume, and raises the named
    :class:`PlannerError` (a ``ValueError``) for contradictory or
    infeasible requests (``schedule=`` without the mesh lfvt path,
    ``pad=`` on the loop lfvt path, ``pair_capacity`` with
    ``emit='mask'``).

The calibration reads rows of the reference's schema. The committed
rows are CPU timings of the JAX package, so on the card the port
rescales from them exactly as the reference does (its plans equal the
reference's, calibrated or not) until rows timed on the card exist.

Every decision lands in driver stats (``stats["plan"]``); planning
alters which method runs, never the result.
:class:`JoinStats` is the typed view over the drivers' stats mapping
(``.to_dict()`` stays byte-compatible with ``benchmarks/``).

The model intentionally predicts *ordering*, not wall clock: bitmap
cost is linear in W = ceil(U/32) while the walk cost is U-independent,
so the pick flips from bitmap to lfvt as U grows.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import math
import os
from typing import Any, Iterator, Mapping

import numpy as np

from .config import global_config
from .measures import get_measure

__all__ = [
    "PlannerError", "JoinPlan", "JoinStats", "probe_features",
    "score_methods", "choose_method", "build_plan", "plan_shard_methods",
    "load_calibration", "effective_coeffs", "validate_join_args",
    "BENCH_GLOB",
    "DEFAULT_COEFFS", "KNOWN_METHODS", "AUTO_CANDIDATES",
    "SHARD_CANDIDATES",
]


class PlannerError(ValueError):
    """A contradictory or infeasible join plan request.

    Subclasses ``ValueError`` so pre-existing ``pytest.raises(ValueError)``
    call sites (and callers catching ValueError) keep working; the message
    text of the historical driver checks is preserved verbatim.
    """


#: every method name the reference's drivers accept
KNOWN_METHODS = ("popcount", "onehot", "kernel_bitmap", "kernel_onehot",
                 "lfvt", "lfvt_ref")

#: families ``method='auto'`` chooses between for a whole join. The
#: ``kernel_*`` bitmap-kernel variants are deliberately absent: they
#: share the bitmap family's cost shape, so the planner maps
#: the bitmap family to ``popcount``. ``lfvt_ref`` is scored (it is a
#: degradation rung) but strictly dominated by ``lfvt`` in the model.
AUTO_CANDIDATES = ("popcount", "onehot", "lfvt", "lfvt_ref")

#: per-shard candidates on the MR loop path — the paper's adaptive
#: granularity: light small-universe shards take the bitmap popcount,
#: heavy shards take the planned LFVT walk.
SHARD_CANDIDATES = ("popcount", "lfvt")

_FAMILY_OF = {"popcount": "bitmap", "kernel_bitmap": "bitmap",
              "onehot": "onehot", "kernel_onehot": "onehot",
              "lfvt": "lfvt", "lfvt_ref": "lfvt_ref"}

# Embedded default coefficients, fitted by hand against the committed
# full-run BENCH rows (BENCH_pr4/pr8 method_axis: midW m=n=320 U=2^13
# bitmap 0.100s / lfvt 0.310s; largeW m=n=192 U=2^21 bitmap 10.4s /
# lfvt 0.127s; onehot midW-smoke 0.023s). Units per family:
#   bitmap  : work = window_frac * m * n * W      (popcount cells)
#   onehot  : work = m * n * U                    (scan over U cols)
#   lfvt    : work = sum_a freq_R(a) * freq_S(a)  (walk traffic)
# plus a per-row-tile dispatch term for the walk paths (each ragged
# tile pays lane setup) and a per-call fixed dispatch cost.
DEFAULT_COEFFS: dict[str, dict[str, float]] = {
    "bitmap": {"fixed": 1.0e-3, "per_byte": 2.0e-9, "per_unit": 8.0e-9,
               "per_tile": 0.0},
    "onehot": {"fixed": 2.0e-3, "per_byte": 1.0e-9, "per_unit": 6.0e-10,
               "per_tile": 0.0},
    "lfvt": {"fixed": 5.0e-3, "per_byte": 2.0e-9, "per_unit": 1.0e-6,
             "per_tile": 2.0e-3},
    # the whole-block walk re-walks dead lanes the kernel skips
    # (BENCH kernel_vs_ref_walk_ratio ~ 0.8)
    "lfvt_ref": {"fixed": 5.0e-3, "per_byte": 2.0e-9, "per_unit": 1.25e-6,
                 "per_tile": 2.5e-3},
}


# ---------------------------------------------------------------------- #
# input probe
# ---------------------------------------------------------------------- #
def _rows_view(C, rows):
    if rows is None:
        return C.sets, C.sizes()
    rows = np.asarray(rows, dtype=np.int64)
    return [C.sets[int(i)] for i in rows], C.sizes()[rows]


def probe_features(R, S, t: float, measure: str = "jaccard",
                   r_rows=None, s_rows=None) -> dict[str, Any]:
    """Cheap host probe of one join (optionally restricted to routed row
    subsets, for per-shard planning): O(m + n + total elements).

    ``walk_units`` is the *exact* expected flat-LFVT walk traffic
    ``sum_a freq_R(a) * freq_S(a)`` — every R-side occurrence of element
    ``a`` walks ``seq(a)``, whose length is S's frequency of ``a``.
    ``zipf_head_mass`` is the share of S-side element occurrences held
    by the top ``planner_head_frac`` of distinct elements (skew widens
    the hottest chains, which is what moves the crossover).
    """
    meas = get_measure(measure)
    r_sets, r_sizes = _rows_view(R, r_rows)
    s_sets, s_sizes = _rows_view(S, s_rows)
    m, n = len(r_sets), len(s_sets)
    universe = int(max(R.universe, S.universe, 1))
    w_words = (universe + 31) // 32
    r_elems = int(np.asarray(r_sizes).sum()) if m else 0
    s_elems = int(np.asarray(s_sizes).sum()) if n else 0
    feats: dict[str, Any] = {
        "m": m, "n": n, "universe": universe, "w_words": w_words,
        "r_elems": r_elems, "s_elems": s_elems,
        "max_r": int(np.asarray(r_sizes).max(initial=0)) if m else 0,
        "max_s": int(np.asarray(s_sizes).max(initial=0)) if n else 0,
        "density": s_elems / float(max(n, 1) * universe),
        "window_frac": meas.window_fraction(r_sizes, s_sizes, t),
        "walk_units": 0, "distinct_s": 0, "zipf_head_mass": 0.0,
    }
    if not s_elems:
        return feats
    vals_s, cnt_s = np.unique(
        np.concatenate([np.asarray(s) for s in s_sets if len(s)]),
        return_counts=True)
    feats["distinct_s"] = int(len(vals_s))
    k = max(1, math.ceil(global_config.planner_head_frac * len(vals_s)))
    k = min(k, len(vals_s))
    feats["zipf_head_mass"] = float(
        np.sort(cnt_s)[-k:].sum() / float(s_elems))
    if r_elems:
        vals_r, cnt_r = np.unique(
            np.concatenate([np.asarray(s) for s in r_sets if len(s)]),
            return_counts=True)
        idx = np.clip(np.searchsorted(vals_s, vals_r), 0, len(vals_s) - 1)
        hit = vals_s[idx] == vals_r
        feats["walk_units"] = int(
            (cnt_r[hit].astype(np.int64) * cnt_s[idx[hit]]).sum())
    return feats


# ---------------------------------------------------------------------- #
# cost model
# ---------------------------------------------------------------------- #
def _family_workload(family: str, f: Mapping[str, Any]) -> dict[str, float]:
    """(bytes_staged, work_units, tiles) for one rep family, from probe
    features only — the quantities the coefficients multiply."""
    m, n = f["m"], f["n"]
    W, U = f["w_words"], f["universe"]
    tiles = max(1, -(-m // max(int(global_config.row_tile), 1)))
    if family == "bitmap":
        return {"bytes_staged": float((m + n) * W * 4),
                "work_units": float(f["window_frac"]) * m * n * W,
                "tiles": 0.0}
    if family == "onehot":
        return {"bytes_staged": float((m + n) * U * 4),
                "work_units": float(m) * n * U, "tiles": 0.0}
    # flat-LFVT families: CSR tables (entry triplet + seq/hop + sizes)
    # plus the padded R rows; size scales with sum |seq|, never with U
    flat_bytes = 4.0 * (3 * f["distinct_s"] + 2 * f["s_elems"] + n)
    r_bytes = 4.0 * m * max(f["max_r"], 1)
    return {"bytes_staged": flat_bytes + r_bytes,
            "work_units": float(f["walk_units"]), "tiles": float(tiles)}


def score_methods(features: Mapping[str, Any],
                  coeffs: Mapping[str, Mapping[str, float]] | None = None,
                  candidates: tuple[str, ...] = AUTO_CANDIDATES,
                  ) -> dict[str, dict[str, float]]:
    """Predicted cost per candidate method -> ``{method: {bytes_staged,
    work_units, tiles, seconds}}``. Bitmap/onehot scores grow linearly
    with the universe; the walk scores do not — the structural source of
    the bitmap->lfvt flip as U grows."""
    coeffs = coeffs if coeffs is not None else effective_coeffs()
    out: dict[str, dict[str, float]] = {}
    for meth in candidates:
        fam = _FAMILY_OF[meth]
        c = coeffs[fam]
        w = _family_workload(fam, features)
        w["seconds"] = (c["fixed"] + c["per_byte"] * w["bytes_staged"]
                        + c["per_unit"] * w["work_units"]
                        + c.get("per_tile", 0.0) * w["tiles"])
        out[meth] = w
    return out


def choose_method(scores: Mapping[str, Mapping[str, float]],
                  candidates: tuple[str, ...] = AUTO_CANDIDATES) -> str:
    """Lowest predicted seconds; ties break toward the earlier candidate
    (popcount before the walk — cheaper to stage, simpler to debug)."""
    ranked = [m for m in candidates if m in scores]
    if not ranked:
        raise PlannerError("no feasible method candidate to choose from")
    return min(ranked, key=lambda m: (scores[m]["seconds"],
                                      ranked.index(m)))


# ---------------------------------------------------------------------- #
# calibration from committed BENCH artifacts
# ---------------------------------------------------------------------- #
def _bench_workload(method: str, impl: str, met: Mapping[str, Any]):
    """Reconstruct (family, workload) from one BENCH method_axis row's
    metrics; None when the row lacks what the model needs."""
    m, n, U = met.get("m"), met.get("n"), met.get("universe")
    if not all(isinstance(v, (int, float)) and v for v in (m, n, U)):
        return None
    W = (int(U) + 31) // 32
    if method == "bitmap":
        # bench workloads run t=0.5 Jaccard over Zipf sizes: the window
        # keeps about half the sheet — close enough for a scale fit
        return "bitmap", {"bytes_staged": float((m + n) * W * 4),
                          "work_units": 0.5 * m * n * W, "tiles": 0.0}
    if method == "onehot":
        return "onehot", {"bytes_staged": float((m + n) * U * 4),
                          "work_units": float(m) * n * U, "tiles": 0.0}
    if method == "lfvt":
        steps = met.get("walk_steps") or met.get("total_seq_tuples")
        if not isinstance(steps, (int, float)):
            return None
        fam = "lfvt_ref" if impl == "ref" else "lfvt"
        byts = met.get("s_flat_bytes")
        if not isinstance(byts, (int, float)):
            byts = 4.0 * 5 * met.get("total_seq_tuples", 0)
        tiles = max(1, -(-int(m) // max(int(global_config.row_tile), 1)))
        return fam, {"bytes_staged": float(byts),
                     "work_units": float(steps), "tiles": float(tiles)}
    return None


#: the BENCH artifacts calibration reads, relative to the working directory
BENCH_GLOB = "BENCH_pr*.json"
#: clamp on a family's scale, so one noisy BENCH row cannot invert a
#: decision
SCALE_MIN, SCALE_MAX = 0.2, 5.0


def load_calibration(paths) -> dict[str, dict[str, float]]:
    """Per-family rescale of :data:`DEFAULT_COEFFS` from the
    ``method_axis`` rows of the given BENCH artifacts.

    Only the current consolidated row schema is read; older dict-keyed
    artifacts and rows with ``seconds=null`` (infeasible
    cells) are skipped silently — with no usable rows the defaults stand.
    The scale is the *geometric mean* of per-row measured/predicted
    ratios (a log-space one-parameter fit): every row counts equally,
    so a family whose corpus mixes second-scale full runs with
    millisecond smoke rows is not fit solely to the big rows — the
    failure mode of a dot-product least-squares fit, which can invert
    the popcount/onehot ordering at mid sizes. The scale is clamped to
    ``[SCALE_MIN, SCALE_MAX]`` so a noisy artifact
    cannot swing a decision arbitrarily, and multiplies every
    coefficient of its family uniformly.
    """
    pred: dict[str, list[float]] = {}
    meas: dict[str, list[float]] = {}
    for path in paths:
        try:
            with open(path) as fh:
                doc = json.load(fh)
            rows = doc.get("rows", []) if isinstance(doc, dict) else []
        except (OSError, json.JSONDecodeError):
            continue
        for row in rows:
            if not isinstance(row, dict):
                continue
            if not str(row.get("config", "")).startswith("method_axis/"):
                continue
            met = row.get("metrics", {})
            secs = met.get("seconds")
            if not isinstance(secs, (int, float)) or secs <= 0:
                continue
            got = _bench_workload(row.get("method", ""),
                                  row.get("impl", ""), met)
            if got is None:
                continue
            fam, w = got
            c = DEFAULT_COEFFS[fam]
            p = (c["fixed"] + c["per_byte"] * w["bytes_staged"]
                 + c["per_unit"] * w["work_units"]
                 + c.get("per_tile", 0.0) * w["tiles"])
            pred.setdefault(fam, []).append(p)
            meas.setdefault(fam, []).append(float(secs))
    coeffs = {fam: dict(c) for fam, c in DEFAULT_COEFFS.items()}
    for fam, ps in pred.items():
        ratios = [mv / pv for pv, mv in zip(ps, meas[fam]) if pv > 0.0]
        if not ratios:
            continue
        scale = float(np.exp(np.mean(np.log(ratios))))
        scale = min(max(scale, SCALE_MIN), SCALE_MAX)
        coeffs[fam] = {k: v * scale for k, v in coeffs[fam].items()}
    return coeffs


_calib_cache: dict[tuple, dict] = {}


def effective_coeffs() -> dict[str, dict[str, float]]:
    """The coefficients in force: defaults, rescaled from whatever
    ``BENCH_GLOB`` artifacts exist in the working directory
    (memoized per file-stat signature; ``planner_calibrate=False``
    pins the embedded defaults)."""
    if not global_config.planner_calibrate:
        return DEFAULT_COEFFS
    paths = sorted(glob.glob(BENCH_GLOB))
    sig = []
    for p in paths:
        try:
            st = os.stat(p)
            sig.append((p, st.st_mtime_ns, st.st_size))
        except OSError:
            continue
    key = tuple(sig)
    got = _calib_cache.get(key)
    if got is None:
        got = load_calibration([p for p, _, _ in sig])
        _calib_cache.clear()  # signatures change rarely; keep one entry
        _calib_cache[key] = got
    return got


# ---------------------------------------------------------------------- #
# plan + stats dataclasses
# ---------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class JoinPlan:
    """The planner's decision record, consumed by the driver.

    ``method`` is always a concrete method name (never ``'auto'``);
    ``requested`` keeps what the caller asked for. ``shard_methods`` is
    set only for the heterogeneous MR loop path. ``decided`` records how
    ``method`` was fixed: ``'forced'`` (caller named it),
    ``'cost_model'``, or ``'empty'`` (degenerate inputs, nothing to
    score). ``features``/``scores`` are the probe and per-candidate
    predictions when the cost model ran.
    """

    method: str
    requested: str = "auto"
    driver: str = "device"
    measure: str = "jaccard"
    emit: str = "pairs"
    r_block: int | None = None
    row_tile: int | None = None
    pad: str | None = None
    schedule: str | None = None
    pair_capacity: int | None = None
    double_buffer: bool | None = None
    shard_methods: tuple[str, ...] | None = None
    decided: str = "forced"
    features: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    scores: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["features"] = dict(self.features)
        d["scores"] = {k: dict(v) for k, v in self.scores.items()}
        if self.shard_methods is not None:
            d["shard_methods"] = list(self.shard_methods)
        return d

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "JoinPlan":
        kw = {f.name: d[f.name] for f in dataclasses.fields(cls)
              if f.name in d}
        if kw.get("shard_methods") is not None:
            kw["shard_methods"] = tuple(kw["shard_methods"])
        return cls(**kw)


_STAT_FIELDS = (
    # typed views over the drivers' stats keys (aliases tried in order)
    ("method", ("method",)),
    ("measure", ("measure",)),
    ("emit", ("emit",)),
    ("result_pairs", ("result_pairs", "pair_count")),
    ("reduce_bytes", ("reduce_bytes", "output_bytes")),
    ("dense_mask_bytes", ("dense_mask_bytes",)),
    ("reduce_mask_peak_bytes", ("reduce_mask_peak_bytes",)),
    ("walk_steps", ("walk_steps",)),
    ("early_stops", ("early_stops",)),
    ("live_tiles", ("live_tiles",)),
    ("total_tiles", ("total_tiles",)),
    ("regrows", ("regrows",)),
    ("retries", ("retries",)),
    ("degradations", ("degradations",)),
    ("plan", ("plan",)),
)


@dataclasses.dataclass(frozen=True)
class JoinStats(Mapping):
    """Frozen, typed view over a driver stats dict.

    The drivers keep filling a plain mapping (shared with benchmarks and
    the regression gate); this wraps it with typed attribute access
    while ``.to_dict()`` returns the underlying mapping byte-compatibly
    — same keys, same values, so ``benchmarks/check_regression.py`` and
    every existing consumer that indexes by key keep working. Implements
    the ``Mapping`` protocol for drop-in reads.
    """

    method: str | None = None
    measure: str | None = None
    emit: str | None = None
    result_pairs: int | None = None
    reduce_bytes: int | None = None
    dense_mask_bytes: int | None = None
    reduce_mask_peak_bytes: int | None = None
    walk_steps: int | None = None
    early_stops: int | None = None
    live_tiles: int | None = None
    total_tiles: int | None = None
    regrows: int | None = None
    retries: int | None = None
    degradations: tuple = ()
    plan: Mapping[str, Any] | None = None
    raw: Mapping[str, Any] = dataclasses.field(default_factory=dict,
                                               repr=False)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "JoinStats":
        kw: dict[str, Any] = {"raw": dict(d)}
        for field, aliases in _STAT_FIELDS:
            for key in aliases:
                if key in d:
                    val = d[key]
                    kw[field] = (tuple(val) if field == "degradations"
                                 and val is not None else val)
                    break
        return cls(**kw)

    def to_dict(self) -> dict:
        return dict(self.raw)

    # Mapping protocol: reads hit the raw driver dict untouched
    def __getitem__(self, key: str) -> Any:
        return self.raw[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self.raw)

    def __len__(self) -> int:
        return len(self.raw)


# ---------------------------------------------------------------------- #
# the kwarg lattice (single validation point for both drivers)
# ---------------------------------------------------------------------- #
def validate_join_args(*, driver: str = "device", method: str, emit: str,
                       pad: str | None = None, pad_explicit: bool = False,
                       schedule: str | None = None,
                       pair_capacity: int | None = None,
                       has_mesh: bool = False) -> None:
    """Validate the full driver kwarg lattice in one place.

    Raises :class:`PlannerError` (a ``ValueError``) with the reference's
    message text (pinned in ``tests/test_torch_join.py`` and
    ``tests/test_torch_mr.py``).
    """
    if emit not in ("pairs", "mask"):
        raise PlannerError(f"unknown emit mode {emit!r}")
    if method != "auto" and method not in KNOWN_METHODS:
        raise PlannerError(f"unknown method {method!r}")
    if pair_capacity is not None and emit == "mask":
        raise PlannerError(
            f"pair_capacity={pair_capacity!r} has no effect with "
            "emit='mask' (the dense mask path never compacts pairs); "
            "drop it or use emit='pairs'")
    if driver == "device":
        return
    if schedule not in (None, "planned", "static"):
        raise PlannerError(f"unknown walk schedule {schedule!r}")
    if pad is not None and pad not in ("auto", "global", "bucket"):
        raise PlannerError(f"unknown pad mode {pad!r}")
    if schedule is not None and method not in ("lfvt", "auto"):
        raise PlannerError(
            f"schedule={schedule!r} only applies to the mesh lfvt walk; "
            f"method={method!r} never consults it — drop the kwarg or "
            "use method='lfvt'")
    if (pad_explicit and pad not in (None, "auto") and not has_mesh
            and method in ("lfvt", "lfvt_ref")):
        raise PlannerError(
            f"pad={pad!r} has no effect on the loop lfvt path (shards "
            "stay ragged; padding only exists under a mesh) — drop the "
            "kwarg or pass a mesh")
    if has_mesh and method == "lfvt_ref":
        raise PlannerError(
            "method='lfvt_ref' runs on the loop path only (mesh=None); "
            "use method='lfvt' for the bucketed shard_map mesh path")


# ---------------------------------------------------------------------- #
# plan construction
# ---------------------------------------------------------------------- #
def plan_shard_methods(R, S, t: float, part, *, measure: str,
                       coeffs=None) -> tuple[str, ...]:
    """Score each routed MR shard independently -> one method per shard
    (the paper's per-partition adaptation granularity). Empty shards
    keep the cheapest family."""
    coeffs = coeffs if coeffs is not None else effective_coeffs()
    s_rows, r_rows = part.shard_rows(R, S)
    picks = []
    for k in range(part.n_shards):
        if not len(r_rows[k]) or not len(s_rows[k]):
            picks.append(SHARD_CANDIDATES[0])
            continue
        f = probe_features(R, S, t, measure,
                           r_rows=r_rows[k], s_rows=s_rows[k])
        picks.append(choose_method(
            score_methods(f, coeffs, SHARD_CANDIDATES), SHARD_CANDIDATES))
    return tuple(picks)


def build_plan(R=None, S=None, t: float | None = None, *,
               driver: str = "device", method: str = "auto",
               measure: str = "jaccard", emit: str = "pairs",
               has_mesh: bool = False, pad: str | None = None,
               pad_explicit: bool = False, schedule: str | None = None,
               pair_capacity: int | None = None, r_block: int | None = None,
               row_tile: int | None = None,
               double_buffer: bool | None = None, part=None) -> JoinPlan:
    """Validate the kwarg lattice and resolve ``method='auto'`` into a
    concrete :class:`JoinPlan`.

    Both drivers call this (their legacy kwargs map onto plan overrides
    here); ``repro_torch.join`` surfaces the result. With a forced
    method the cost model never runs — the plan just records the request
    plus the resolved tuning knobs. On the MR loop path (``driver='mr'``,
    no mesh, ``part`` with more than one shard) ``'auto'`` also scores
    every routed shard (``plan_shard_methods``).
    """
    validate_join_args(driver=driver, method=method, emit=emit, pad=pad,
                       pad_explicit=pad_explicit, schedule=schedule,
                       pair_capacity=pair_capacity, has_mesh=has_mesh)
    requested = method
    decided = "forced"
    features: dict[str, Any] = {}
    scores: dict[str, Any] = {}
    shard_methods: tuple[str, ...] | None = None
    if method == "auto":
        if R is None or S is None or not len(R) or not len(S):
            method, decided = "popcount", "empty"
        else:
            coeffs = effective_coeffs()
            features = probe_features(R, S, t, measure)
            # mesh shards share one shape family: the pick must be
            # homogeneous, and only popcount/lfvt have mesh paths
            candidates = (("popcount", "lfvt") if has_mesh
                          else AUTO_CANDIDATES)
            scores = score_methods(features, coeffs, candidates)
            method = choose_method(scores, candidates)
            decided = "cost_model"
            if (driver == "mr" and not has_mesh and part is not None
                    and part.n_shards > 1):
                shard_methods = plan_shard_methods(
                    R, S, t, part, measure=measure, coeffs=coeffs)
    return JoinPlan(
        method=method, requested=requested, driver=driver, measure=measure,
        emit=emit,
        r_block=int(r_block if r_block else global_config.r_block),
        row_tile=int(row_tile if row_tile else global_config.row_tile),
        pad=pad, schedule=schedule, pair_capacity=pair_capacity,
        double_buffer=(bool(global_config.double_buffer)
                       if double_buffer is None else bool(double_buffer)),
        shard_methods=shard_methods, decided=decided,
        features=features, scores=scores)
