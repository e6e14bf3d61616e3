"""Per-layer numbers read from the program's own spans and counters.

The program records them under ``repro_torch.trace.recording()``: spans
``(name, op, parent, t0_ns, t1_ns)`` stamped with ``time.time_ns()``, the
clock of the profiler's host events, and counters by name. This module
turns a recording into the per-layer numbers of PERF.md §3, beside the
harness, so that a change to the program cannot change how its spans are
measured. ``rec`` below is anything with ``spans`` (such tuples) and
``counters``; an op is one root ``repro_torch.join`` span, and the ops
numbered from ``first`` on are the window's (those before, set-up's).

A span's self time is its duration less the part of it that its child
spans cover.
"""
from __future__ import annotations

import bisect
import statistics
from collections import Counter, defaultdict

from .yardstick import busy_seconds

__all__ = ["ROOT", "OUTSIDE", "LAYERS", "layer_of", "self_ns",
           "window_ops", "ms_per_op", "plan_ms_per_op",
           "collection_ms_per_op", "driver_self_ms_per_op", "s_stage_s",
           "self_ms_by_name", "span_counts", "decomposition", "root_seconds",
           "root_self_share", "counters_between", "self_segments",
           "idle_by_span", "clock_gaps_us", "clock_slack_us"]

P = "repro_torch."
#: one call of ``repro_torch.join``
ROOT = P + "join"
#: the profiler's range around each timed call (``run.py``)
HARNESS_JOIN = "portbench.join"
#: idle time in no program span
OUTSIDE = "outside any span"
PLANNER = (P + "plan", P + "plan.probe")
DRIVER = tuple(P + n for n in ("driver", "bounds", "block.dispatch",
                               "block.operands", "block.finalize",
                               "block.compact"))
STAGE = P + "stage_s"
#: span name -> its layer in the decomposition of an op's time
LAYERS = {
    ROOT: "join self", P + "result": "result",
    **{n: "planner" for n in PLANNER},
    **{n: "driver" for n in DRIVER},
    P + "block.upload": "upload",
    P + "block.sync": "device wait", P + "block.fetch": "device wait",
    **{STAGE + s: "staging" for s in ("", ".sort", ".upload", ".pad_sheet",
                                      ".compress_s")},
}


def layer_of(name: str) -> str:
    """The decomposition's layer of a span name ("other" if unknown)."""
    if name.startswith(P + "sets."):
        return "collections"
    return LAYERS.get(name, "other")


def self_ns(spans) -> list:
    """Each span's self time in ns: its duration less the union of its
    child spans' intervals inside it (an open span counts 0)."""
    kids = defaultdict(list)
    for s in spans:
        if s[2] >= 0:
            kids[s[2]].append((s[3], s[4]))
    out = []
    for i, s in enumerate(spans):
        dur = max(s[4] - s[3], 0)
        out.append(dur - busy_seconds(kids[i], s[3], s[4]) if dur else 0)
    return out


def window_ops(rec, first: int) -> list:
    """The ops (root spans' op ids) numbered ``first`` or later."""
    return sorted({s[1] for s in rec.spans if s[0] == ROOT and s[1] >= first})


def ms_per_op(rec, first: int, keep):
    """Σ self time of the window's spans that ``keep(name)`` accepts, in
    ms per window op; None with no window op."""
    own = self_ns(rec.spans)
    total = sum(own[i] for i, s in enumerate(rec.spans)
                if s[1] >= first and keep(s[0]))
    n = len(window_ops(rec, first))
    return total / n / 1e6 if n else None


def plan_ms_per_op(rec, first: int):
    """plan_ms_per_op (ms): the planner's self time an op, the probe of
    ``auto`` included."""
    return ms_per_op(rec, first, PLANNER.__contains__)


def collection_ms_per_op(rec, first: int):
    """collection_ms_per_op (ms): the self time of ``SetCollection``'s
    rep builds (``repro_torch.sets.*``) an op."""
    return ms_per_op(rec, first, lambda n: n.startswith(P + "sets."))


def driver_self_ms_per_op(rec, first: int):
    """driver_self_ms_per_op (ms): the tile driver's own host time an op,
    kernel launches included; uploads, device waits, staging and
    collection builds are its children's."""
    return ms_per_op(rec, first, DRIVER.__contains__)


def s_stage_s(rec, op: int = 0):
    """s_stage_s (s): the summed duration of the ``stage_s`` spans of op
    ``op`` (set-up's first, which stages S); None if it has none."""
    got = [s[4] - s[3] for s in rec.spans if s[0] == STAGE and s[1] == op]
    return sum(got) / 1e9 if got else None


def self_ms_by_name(rec, first: int) -> dict:
    """The window's self time by span name, ms per window op."""
    own = self_ns(rec.spans)
    n = max(len(window_ops(rec, first)), 1)
    out: dict = defaultdict(float)
    for i, s in enumerate(rec.spans):
        if s[1] >= first:
            out[s[0]] += own[i] / 1e6 / n
    return dict(out)


def span_counts(rec, first: int) -> dict:
    """How many spans of each name the window's ops opened: ops (the
    root), blocks (``block.dispatch``), rep builds (``sets.<rep>``), S
    stagings (``stage_s``), probes (``plan.probe``)."""
    return dict(sorted(Counter(s[0] for s in rec.spans
                               if s[1] >= first).items()))


def decomposition(rec, first: int) -> dict:
    """The mean window op's time by layer, ms: every span's self time
    goes to its layer, so the layers sum to the mean root span."""
    out: dict = defaultdict(float)
    for name, ms in self_ms_by_name(rec, first).items():
        out[layer_of(name)] += ms
    return dict(out)


def root_seconds(rec, first: int) -> list:
    """The durations, s, of the window's root spans, in op order."""
    return [(s[4] - s[3]) / 1e9 for s in sorted(
        (s for s in rec.spans if s[0] == ROOT and s[1] >= first),
        key=lambda s: s[1])]


def root_self_share(rec, first: int):
    """The median over the window's ops of the root span's self time as
    a share of its duration, %: the time no program span covers."""
    own = self_ns(rec.spans)
    shares = [100.0 * own[i] / (s[4] - s[3])
              for i, s in enumerate(rec.spans)
              if s[0] == ROOT and s[1] >= first and s[4] > s[3]]
    return statistics.median(shares) if shares else None


def counters_between(before: dict, after: dict) -> dict:
    """What each counter added between two readings (those that moved)."""
    return {k: v - before.get(k, 0) for k, v in sorted(after.items())
            if v != before.get(k, 0)}


def self_segments(spans) -> list:
    """(start, end, name) of every stretch of time in which a span is the
    innermost one open, in time order (spans nest: one thread records)."""
    kids = defaultdict(list)
    for i, s in enumerate(spans):
        if s[2] >= 0:
            kids[s[2]].append(i)
    out = []
    for i, s in enumerate(spans):
        t = s[3]
        for k in sorted(kids[i], key=lambda k: spans[k][3]):
            if spans[k][3] > t:
                out.append((t, spans[k][3], s[0]))
            t = max(t, spans[k][4])
        if s[4] > t:
            out.append((t, s[4], s[0]))
    return sorted(out)


def idle_by_span(rec, trace, k: int = 10):
    """The device's idle seconds in the trace's window by the innermost
    program span open across them: each idle gap is split over the spans
    it overlaps, and what no span covers goes to ``OUTSIDE`` -> (the top
    ``k`` as [label, s], the share of all idle time under a program span
    other than the root, %)."""
    gaps, reach = [], trace.start
    for a, b in sorted((a, b) for _, a, b in trace.device):
        a, b = max(a, trace.start), min(b, trace.end)
        if b <= a:
            continue
        if a > reach:
            gaps.append((reach, a))
        reach = max(reach, b)
    if trace.end > reach:
        gaps.append((reach, trace.end))
    segs = self_segments(rec.spans)
    starts = [a for a, _, _ in segs]
    out: dict = defaultdict(float)
    for a, b in gaps:
        covered = 0
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(segs) and segs[i][0] < b:
            lap = min(b, segs[i][1]) - max(a, segs[i][0])
            if lap > 0:
                out[segs[i][2]] += lap
                covered += lap
            i += 1
        if b - a > covered:
            out[OUTSIDE] += b - a - covered
    idle = sum(out.values())
    inner = sum(v for n, v in out.items() if n not in (ROOT, OUTSIDE))
    top = [[n, v / 1e9] for n, v in
           sorted(out.items(), key=lambda kv: (-kv[1], kv[0]))[:k]]
    return top, (100.0 * inner / idle if idle else None)


def clock_gaps_us(rec, trace, first: int) -> list:
    """For each window op, in op order, (its root span's start less the
    start of the profiler's ``portbench.join`` range that starts nearest
    it, that range's end less the root span's end), µs: both positive
    when the range holds the span."""
    ranges = sorted((a, b) for n, a, b in trace.host if n == HARNESS_JOIN)
    starts = [a for a, _ in ranges]
    out = []
    for s in sorted(rec.spans, key=lambda s: s[1]):
        if s[0] != ROOT or s[1] < first or not ranges:
            continue
        i = bisect.bisect_left(starts, s[3])
        a, b = min(ranges[max(i - 1, 0):i + 1],
                   key=lambda r: abs(r[0] - s[3]))
        out.append(((s[3] - a) / 1e3, (b - s[4]) / 1e3))
    return out


def clock_slack_us(rec, trace, first: int):
    """span_clock_slack_us: the larger of each window op's two gaps
    (``clock_gaps_us``, either sign), worst over the window, µs; None
    without such ranges."""
    gaps = clock_gaps_us(rec, trace, first)
    return max(max(abs(a), abs(b)) for a, b in gaps) if gaps else None
