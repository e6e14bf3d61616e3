"""The benchmark's arithmetic on fixed inputs: percentile, rate, busy
union, idle share, idle-gap labels, trace sums and copy bytes."""
import json

import numpy as np
import pytest

from portbench import yardstick
from portbench.trace import WINDOW, Trace, chrome_copy_bytes


@pytest.mark.parametrize("values", [[5.0], [3.0, 1.0, 2.0],
                                    list(range(1, 101)),
                                    [0.41, 0.39, 0.52, 0.40, 0.44, 0.61]])
@pytest.mark.parametrize("q", [50, 95, 99])
def test_percentile_is_numpys_linear(values, q):
    assert yardstick.percentile(values, q) == pytest.approx(
        float(np.percentile(values, q)), abs=1e-12)


def test_percentile_of_100_ops_has_five_beyond():
    ops = [float(i) for i in range(100)]
    p95 = yardstick.percentile(ops, 95)
    assert p95 == pytest.approx(94.05)
    assert sum(v > p95 for v in ops) == 5
    with pytest.raises(ValueError):
        yardstick.percentile([], 95)


def test_rate():
    assert yardstick.rate(16384 * 100, 51.2) == pytest.approx(32000.0)
    with pytest.raises(ValueError):
        yardstick.rate(1, 0)


def test_busy_seconds_counts_overlaps_once_and_clips():
    spans = [(0, 10), (5, 15), (20, 30), (22, 25), (40, 41)]
    assert yardstick.busy_seconds(spans) == 26
    assert yardstick.busy_seconds(spans, 8, 24) == 11
    assert yardstick.busy_seconds([]) == 0


def test_idle_share():
    assert yardstick.idle_share(2.5, 10.0) == pytest.approx(75.0)
    assert yardstick.idle_share(10.0, 10.0) == pytest.approx(0.0)
    with pytest.raises(ValueError):
        yardstick.idle_share(1.0, 0.0)


def test_label_gaps_names_the_innermost_host_event():
    device = [(0, 10), (30, 40), (60, 100)]
    host = [("portbench.join", 0, 100), ("aten::copy_", 12, 28),
            ("validate", 41, 59)]
    gaps = yardstick.label_gaps(device, host, 0, 110)
    assert gaps == {"aten::copy_": 20, "validate": 20,
                    "host, outside any event": 10}
    one = yardstick.label_gaps(device, [], 0, 100,
                               sampled=lambda a, b: [f"at {(a + b) / 2}"])
    assert one == {"at 20.0": 20, "at 50.0": 20}
    # a gap sampled twice or more is shared out among its samples, before
    # any host event
    many = yardstick.label_gaps(
        device, host, 0, 100,
        sampled=lambda a, b: ["probe", "probe", "probe", "validate"]
        if a == 10 else [])
    assert many == {"probe": 15, "validate": 5 + 20}


def test_trace_sums_inside_the_window():
    tr = Trace(device=[("k_walk(int*)", 0, 10), ("k_walk(int*)", 90, 130),
                       ("Memcpy HtoD", 5, 20), ("other", 50, 60)],
               host=[(WINDOW, 0, 100)], start=0, end=100)
    assert tr.window_s == pytest.approx(100e-9)
    assert tr.busy_s == pytest.approx(40e-9)
    assert tr.kernel_seconds(("k_walk",)) == pytest.approx(20e-9)
    top = tr.top_device_ops()
    assert top[0] == ["k_walk(int*)", pytest.approx(20e-9)]
    assert [n for n, _ in top] == ["k_walk(int*)", "Memcpy HtoD", "other"]


def test_chrome_copy_bytes_reads_the_window_only(tmp_path):
    events = [
        {"ph": "X", "cat": "user_annotation", "name": WINDOW, "ts": 100.0,
         "dur": 50.0},
        {"ph": "X", "cat": "gpu_memcpy", "name":
         "Memcpy HtoD (Pageable -> Device)", "ts": 110.0, "dur": 1.0,
         "args": {"bytes": 4096}},
        {"ph": "X", "cat": "gpu_memcpy", "name":
         "Memcpy HtoD (Pinned -> Device)", "ts": 120.0, "dur": 1.0,
         "args": {"bytes": 1000}},
        {"ph": "X", "cat": "gpu_memcpy", "name":
         "Memcpy DtoH (Device -> Pinned)", "ts": 130.0, "dur": 1.0,
         "args": {"bytes": 8}},
        {"ph": "X", "cat": "gpu_memcpy", "name":
         "Memcpy HtoD (Pageable -> Device)", "ts": 160.0, "dur": 1.0,
         "args": {"bytes": 999999}},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    assert chrome_copy_bytes(str(path)) == {"HtoD": 5096, "DtoH": 8}
    path.write_text(json.dumps({"traceEvents": events[1:]}))
    assert chrome_copy_bytes(str(path)) == {}


def test_record_reads_the_window_on_the_cpu():
    import time

    import torch

    from portbench.trace import record
    with record() as rec:
        with torch.profiler.record_function(WINDOW):
            t = time.perf_counter()
            while time.perf_counter() - t < 0.02:
                torch.randn(200, 200).sum()
    tr = rec.trace
    assert 0.02 <= tr.window_s < 5
    assert rec.export_bytes > 0 and rec.read_s >= 0
    assert tr.device == [] and tr.copy_bytes == {}
    assert any(name.startswith("aten::") for name, _, _ in tr.host)
    assert tr.samples and all(isinstance(lab, str) for _, lab in tr.samples)
    # no device event: the whole window is one idle gap
    gaps = tr.idle_gaps()
    assert sum(v for _, v in gaps) == pytest.approx(tr.window_s)
