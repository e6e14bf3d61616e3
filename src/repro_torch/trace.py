"""Spans and counters on the join path, recorded only when a caller asks.

    from repro_torch import trace

    with trace.recording() as rec:
        repro_torch.join(R, S, 0.8)
    rec.spans      # [Span(name, op, parent, t0_ns, t1_ns), ...]
    rec.counters   # {"repro_torch.block.upload_bytes": 26607616, ...}

``recording()`` is the only switch: tracing is off until it is entered
and off again when it exits, and it does not nest. Off, a span site
costs one test of a module global and hands back one shared object that
does nothing, so it allocates nothing and reads no clock. On, a span
reads ``time.time_ns()`` when it opens and when it closes: the clock of
``torch.profiler``'s host events, so spans line up with a device trace
taken at the same time.

A span's ``parent`` is the index in ``spans`` of the span open around
it, or -1. Its ``op`` is the sequence number, from 0, of the
``repro_torch.join`` span it lies in (the spans of one call share it),
or -1 outside any. Sites name spans and counters without the
``repro_torch.`` prefix, which the recorder adds. Spans and counters
stay in memory until the caller reads them; one thread records.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import NamedTuple

__all__ = ["PREFIX", "ROOT", "Span", "Recorder", "recording", "enabled",
           "span", "count"]

#: what the recorder puts before every span's and counter's name
PREFIX = "repro_torch."
#: the span of one ``repro_torch.join`` call; its spans share its op
ROOT = PREFIX + "join"


class Span(NamedTuple):
    name: str
    op: int
    parent: int
    t0_ns: int
    t1_ns: int  # -1 while the span is open


class Recorder:
    """The spans and counters of one ``recording()``."""

    def __init__(self):
        self.spans: list[Span] = []
        self.counters: dict[str, int] = {}
        self._open: list[int] = []  # indices into spans, innermost last
        self._op = -1               # the op of the open root, else -1
        self._op_root = -1          # the index of that root span
        self._ops = 0               # roots opened so far

    def _enter(self, name: str) -> None:
        name = PREFIX + name
        op = self._op
        if op < 0 and name == ROOT:
            op = self._op = self._ops
            self._op_root = len(self.spans)
            self._ops += 1
        parent = self._open[-1] if self._open else -1
        self._open.append(len(self.spans))
        self.spans.append(Span(name, op, parent, time.time_ns(), -1))

    def _exit(self) -> None:
        t1 = time.time_ns()
        i = self._open.pop()
        self.spans[i] = self.spans[i]._replace(t1_ns=t1)
        if i == self._op_root:
            self._op = self._op_root = -1


class _Open:
    """One span while tracing is on."""

    __slots__ = ("rec", "name")

    def __init__(self, rec: Recorder, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        self.rec._enter(self.name)
        return self

    def __exit__(self, exc_type, exc, tb):
        self.rec._exit()
        return False


class _Off:
    """Every span site while tracing is off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):  # no *args: no tuple to build
        return False


_OFF = _Off()
#: the recorder while ``recording()`` is on, else None
_rec: Recorder | None = None


@contextmanager
def recording():
    """Turn tracing on for the block and yield its :class:`Recorder`.
    RuntimeError when tracing is on already."""
    global _rec
    if _rec is not None:
        raise RuntimeError("repro_torch.trace.recording() is on already; "
                           "it does not nest")
    rec = _rec = Recorder()
    try:
        yield rec
    finally:
        _rec = None


def enabled() -> bool:
    """Whether tracing is on: for a site that builds a name to count."""
    return _rec is not None


def span(name: str):
    """``with span("driver"):`` records the block as a span when tracing
    is on; off, it returns a shared object that does nothing."""
    if _rec is None:
        return _OFF
    return _Open(_rec, name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` when tracing is on."""
    if _rec is not None:
        key = PREFIX + name
        _rec.counters[key] = _rec.counters.get(key, 0) + int(n)
