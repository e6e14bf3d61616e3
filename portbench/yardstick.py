"""The benchmark's end-to-end arithmetic and the reading of a device trace.

Kept here, beside the harness, so that a change to the program cannot
change how it is measured: the rate, the tail, the device-busy union, the
idle share and what the host did while the device waited.
"""
from __future__ import annotations

import heapq
import math

__all__ = ["percentile", "rate", "busy_seconds", "idle_share", "label_gaps"]


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0 < q < 100) of ``values`` by linear
    interpolation between the order statistics at rank q/100 * (n - 1)
    (numpy's default): every value counts, none is dropped."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = q / 100.0 * (len(xs) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(units: float, seconds: float) -> float:
    """``units`` completed in ``seconds`` of wall time, per second."""
    if seconds <= 0:
        raise ValueError("a rate needs a window longer than 0 s")
    return units / seconds


def busy_seconds(spans, start=None, end=None) -> float:
    """Seconds covered by the union of the ``(start, end)`` intervals
    (any unit, returned in that unit), clipped to ``[start, end]`` when
    given: overlapping events (copies beside kernels) count once."""
    busy, reach = 0, None
    for a, b in sorted(spans):
        if start is not None:
            a = max(a, start)
        if end is not None:
            b = min(b, end)
        if b <= a:
            continue
        if reach is None or a >= reach:
            busy += b - a
            reach = b
        elif b > reach:
            busy += b - reach
            reach = b
    return busy


def idle_share(busy: float, window: float) -> float:
    """The share of ``window`` in which the device ran nothing, in %."""
    if window <= 0:
        raise ValueError("an idle share needs a window longer than 0 s")
    return 100.0 * (1.0 - busy / window)


def label_gaps(device_spans, host_events, start, end, sampled=None):
    """The device's idle gaps inside ``[start, end]``, labelled by what the
    host was doing. ``sampled(a, b)`` may return the labels that a sampler
    saw in the gap; when it returns two or more, the gap is shared out
    among them equally. Otherwise the gap goes to the innermost host event
    open at its midpoint (the one that began last), else to the one label
    ``sampled`` returned, else to ``"host, outside any event"``.

    ``device_spans``: (start, end) pairs; ``host_events``: (name, start,
    end). -> {label: seconds idle}, in the spans' unit."""
    gaps, reach = [], start
    for a, b in sorted(device_spans):
        a, b = max(a, start), min(b, end)
        if b <= a:
            continue
        if a > reach:
            gaps.append((reach, a))
        reach = max(reach, b)
    if end > reach:
        gaps.append((reach, end))
    events = sorted(host_events, key=lambda e: e[1])
    out: dict[str, float] = {}
    heap: list = []
    k = 0
    for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (a + b) / 2
        while k < len(events) and events[k][1] <= mid:
            name, s, e = events[k]
            heapq.heappush(heap, (-s, e, name))
            k += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        seen = (sampled and sampled(a, b)) or []
        if len(seen) < 2:
            seen = ([heap[0][2]] if heap else seen
                    or ["host, outside any event"])
        for label in seen:
            out[label] = out.get(label, 0) + (b - a) / len(seen)
    return out
