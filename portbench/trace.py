"""The device trace of a ``--trace 1`` run, read from the profiler.

``torch.profiler`` records the window with CPU and CUDA activities; the
events are read from its raw kineto results (nanoseconds, one clock for
host and device), not through its per-op event tree, whose building takes
minutes for a few hundred thousand events. The window itself is a
``record_function`` span (``WINDOW``), so that it is measured on the
trace's own clock. What comes out:

* ``device``: (name, start, end) of every device event (kernels, copies,
  memsets);
* ``host``: (name, start, end) of every host event (the ATen ops, the
  CUDA runtime calls, the benchmark's spans);
* ``samples``: (time, label) every millisecond of the Python function the
  main thread was in (``HostSampler``), the innermost of the program's;
* ``start``, ``end``: the window, and ``busy_s``, ``window_s``.

The profiler also puts the ``record_function`` spans on the device's
timeline; those are not device work and are left out of ``device``.

The raw events carry no copy sizes, so the copies' bytes are read from
the profiler's Chrome trace, written to a temporary file under ``TMPDIR``
and deleted at once: ``copy_bytes`` sums them by direction ("HtoD",
"DtoH", ...) over the events inside the window span. Nothing else of the
trace is kept.
"""
from __future__ import annotations

import bisect
import json
import os
import sys
import tempfile
import threading
import time
from dataclasses import dataclass, field

from .yardstick import busy_seconds, label_gaps

__all__ = ["WINDOW", "SPAN_PREFIX", "Trace", "HostSampler", "record"]

#: the benchmark's own spans are named SPAN_PREFIX + what they cover
SPAN_PREFIX = "portbench."
WINDOW = SPAN_PREFIX + "window"


@dataclass
class Trace:
    device: list = field(default_factory=list)
    host: list = field(default_factory=list)
    start: int = 0
    end: int = 0
    copy_bytes: dict = field(default_factory=dict)
    samples: list = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e9

    @property
    def busy_s(self) -> float:
        return busy_seconds([(a, b) for _, a, b in self.device],
                            self.start, self.end) / 1e9

    def kernel_seconds(self, keys) -> float:
        """Device seconds, inside the window, of the events whose name
        holds one of ``keys``."""
        return sum(min(b, self.end) - max(a, self.start)
                   for name, a, b in self.device
                   if any(k in name for k in keys)
                   and b > self.start and a < self.end) / 1e9

    def top_device_ops(self, k: int = 10):
        per: dict[str, int] = {}
        for name, a, b in self.device:
            a, b = max(a, self.start), min(b, self.end)
            if b > a:
                per[name] = per.get(name, 0) + b - a
        return [[n, v / 1e9] for n, v in
                sorted(per.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10):
        """The device's idle seconds in the window by what the host was
        doing. A gap that the sampler saw twice or more is shared out
        among the Python functions of its samples; a shorter one goes to
        the innermost profiled host event open at its midpoint (an ATen
        op, a CUDA runtime call), else to the function sampled last
        before it."""
        hosts = [h for h in self.host if not h[0].startswith(SPAN_PREFIX)]
        times = [t for t, _ in self.samples]

        def sampled(a, b):
            i, j = (bisect.bisect_left(times, a),
                    bisect.bisect_right(times, b))
            if j - i >= 2:
                return [f"python: {lab}" for _, lab in self.samples[i:j]]
            i = bisect.bisect_right(times, (a + b) / 2) - 1
            return [f"python: {self.samples[i][1]}"] if i >= 0 else None

        gaps = label_gaps([(a, b) for _, a, b in self.device], hosts,
                          self.start, self.end, sampled=sampled)
        return [[n, v / 1e9] for n, v in
                sorted(gaps.items(), key=lambda kv: -kv[1])[:k]]


def _label(frame) -> str:
    """The innermost frame of the program (``repro_torch``), else of the
    benchmark, else the innermost: ``path:function``."""
    def name(code):
        return getattr(code, "co_qualname", code.co_name)

    for mark in ("repro_torch", "portbench"):
        f = frame
        while f is not None:
            path = f.f_code.co_filename
            if mark in path:
                return f"{mark}{path.rsplit(mark, 1)[1]}:{name(f.f_code)}"
            f = f.f_back
    return (f"{os.path.basename(frame.f_code.co_filename)}:"
            f"{name(frame.f_code)}") if frame is not None else "none"


class HostSampler(threading.Thread):
    """Samples the Python function the thread that made it is in, every
    ``interval`` seconds, as (``time.time_ns()``, label): the profiler's
    host clock. Start it, then ``stop()`` it."""

    def __init__(self, interval: float = 1e-3):
        super().__init__(daemon=True)
        self.target = threading.get_ident()
        self.interval = interval
        self.samples: list = []
        self._halt = threading.Event()

    def run(self):
        while not self._halt.wait(self.interval):
            frame = sys._current_frames().get(self.target)
            self.samples.append((time.time_ns(), _label(frame)))

    def stop(self) -> list:
        self._halt.set()
        self.join()
        return self.samples


def chrome_copy_bytes(path: str) -> dict:
    """{direction: bytes} of the copy events (category ``gpu_memcpy``)
    of a Chrome trace that start inside its ``WINDOW`` span."""
    with open(path) as fh:
        events = json.load(fh).get("traceEvents", [])
    win = [e for e in events if e.get("name") == WINDOW and "dur" in e
           and e.get("cat") == "user_annotation"]
    if not win:
        return {}
    a = win[0]["ts"]
    b = a + win[0]["dur"]
    out: dict[str, int] = {}
    for e in events:
        if e.get("cat") != "gpu_memcpy" or not a <= e.get("ts", -1) < b:
            continue
        name = e.get("name", "")
        way = name.split()[1] if len(name.split()) > 1 else name
        out[way] = out.get(way, 0) + int(e.get("args", {}).get("bytes", 0))
    return out


class record:
    """``with record() as rec:`` profiles the block; ``rec.trace`` holds
    the :class:`Trace` afterwards. Open the window span inside it with
    ``torch.profiler.record_function(WINDOW)``."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.sampler = HostSampler()
        self.sampler.start()
        return self

    def __exit__(self, *exc):
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        samples = self.sampler.stop()
        t = time.perf_counter()
        self.prof.__exit__(*exc)
        if exc[0] is None:
            self.trace = self._read()
            self.trace.samples = samples
        self.read_s = time.perf_counter() - t
        return False

    def _read(self) -> Trace:
        from torch.autograd import DeviceType
        tr = Trace()
        for ev in self.prof.profiler.kineto_results.events():
            name, a, b = ev.name(), ev.start_ns(), ev.end_ns()
            if ev.device_type() == DeviceType.CUDA:
                if not name.startswith(SPAN_PREFIX):
                    tr.device.append((name, a, b))
            else:
                if name == WINDOW:
                    tr.start, tr.end = a, b
                tr.host.append((name, a, b))
        if tr.end <= tr.start:
            raise RuntimeError(f"the trace holds no {WINDOW} span")
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            self.export_bytes = os.path.getsize(path)
            tr.copy_bytes = chrome_copy_bytes(path)
        finally:
            os.unlink(path)
        return tr
