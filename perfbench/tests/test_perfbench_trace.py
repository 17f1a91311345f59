"""The arithmetic of the readers on a small synthetic Chrome trace and
latency list."""

import json

import numpy as np
import pytest

from perfbench import harness, stats
from perfbench.harness import Op, TracedRun, Window
from perfbench.tracing import Trace, union


def _x(name, cat, ts, dur, **args):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if args:
        e["args"] = args
    return e


EVENTS = [
    _x("window", "user_annotation", 0, 1000),
    _x("query", "user_annotation", 0, 400),
    _x("query", "user_annotation", 500, 400),
    _x("aten::to", "cpu_op", 20, 60),
    _x("aten::copy_", "cpu_op", 40, 30),
    _x("bitap_count_kernel", "kernel", 100, 200),
    _x("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 300, 50, bytes=5_000_000),
    _x("bitap_count_kernel", "kernel", 600, 100),
    _x("Memset (Device)", "gpu_memset", 650, 30),
    _x("cudaLaunchKernel", "cuda_runtime", 590, 5),
    {"ph": "i", "name": "marker", "ts": 10},
]

PEAKS = {"Card": {"hbm_bytes_per_s": 1e9}}


def _run(kind="Card"):
    window = Window(setup_s=4.5, start=0.0, end=1e-3,
                    ops=[Op(0.0, 4e-4, 100_000, 0, 7), Op(5e-4, 9e-4, 100_000, 0, 7)])
    return TracedRun(trace=Trace(EVENTS), window=window, kind=kind, peaks=PEAKS)


def test_union_and_busy():
    assert union([(5, 6), (0, 2), (1, 3), (3, 4), (7, 7)]) == [(0, 4), (5, 6)]
    t = Trace(EVENTS)
    assert t.window() == (0.0, 1000.0)
    assert t.busy(0, 1000) == pytest.approx(350.0)
    assert t.busy(120, 620) == pytest.approx(180 + 50 + 20)
    assert t.busy(0, 1000, ("kernel",)) == pytest.approx(300.0)
    assert t.idle_gaps(0, 1000) == [(0, 100.0), (350.0, 600.0), (700.0, 1000)]


def test_readers():
    run = _run()
    read = lambda name: harness.reader("metrics", name)(run)  # noqa: E731
    assert read("device_idle_pct.resident") == pytest.approx(65.0)
    assert read("device_idle_pct.ingest") == pytest.approx(65.0)
    # Two queries of 1e5 bytes at 1e9 B/s need 200 us, over 300 us of kernels.
    assert read("count_roofline_pct") == pytest.approx(200 / 3)
    # 800 us of query spans less 350 us of device work, over two queries.
    assert read("host_ms_per_query") == pytest.approx(0.225)
    # 5e6 bytes over 50 us.
    assert read("htod_GBps") == pytest.approx(100.0)


def test_readers_take_window_totals():
    """A kernel that the device clock places partly before the span that
    launched it still counts whole."""
    shifted = [dict(e) for e in EVENTS]
    for e in shifted:
        if e["name"] == "bitap_count_kernel" and e["ts"] == 600:
            e["ts"] = 450  # 50 us before the second query's span
    run = _run()
    run.trace = Trace(shifted)
    assert harness.reader("metrics", "count_roofline_pct")(run) == pytest.approx(200 / 3)
    # The memset no longer overlaps the kernel: 380 us of device work.
    assert harness.reader("metrics", "host_ms_per_query")(run) == pytest.approx(0.21)


def test_readers_find_nothing_to_read():
    assert harness.reader("metrics", "count_roofline_pct")(_run("Other card")) is None
    empty = TracedRun(trace=Trace([_x("window", "user_annotation", 0, 10)]),
                      window=Window(setup_s=1.0), kind="Card", peaks=PEAKS)
    for name in ("count_roofline_pct", "device_idle_pct.resident", "device_idle_pct.ingest",
                 "host_ms_per_query", "htod_GBps"):
        assert harness.reader("metrics", name)(empty) is None


def test_a_split_metric_reads_with_its_base_file():
    """``device_idle_pct.resident`` and ``.ingest`` have no files of their
    own: both are read by ``metrics/device_idle_pct.py``."""
    base = harness.module("metrics", "device_idle_pct")
    for name in ("device_idle_pct.resident", "device_idle_pct.ingest"):
        assert harness.module("metrics", name).__file__ == base.__file__
    with pytest.raises(FileNotFoundError):
        harness.module("metrics", "no_such_metric.resident")


def test_breakdown():
    t = Trace(EVENTS)
    ops = t.device_ops(0, 1000)
    assert ops[0] == ["bitap_count_kernel", pytest.approx(300e-6)]
    assert [name for name, _ in ops] == ["bitap_count_kernel",
                                         "Memcpy HtoD (Pageable -> Device)", "Memset (Device)"]
    gaps = dict((k, v) for k, v in t.idle_breakdown(0, 1000))
    assert gaps == {"query:aten::copy_": pytest.approx(100e-6),
                    "loop:python": pytest.approx(250e-6),
                    "query:python": pytest.approx(300e-6)}
    json.dumps(gaps)


@pytest.mark.parametrize("n", [1, 2, 5, 20, 101, 1000])
def test_percentile_matches_numpy(n):
    xs = list(np.random.default_rng(n).exponential(1.0, n))
    for q in (0, 50, 95, 100):
        assert stats.percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)))


def test_end_to_end_readers():
    lat = [1.0] * 90 + [2.0] * 9 + [10.0]
    ops, t = [], 0.0
    for ms in lat:
        ops.append(Op(t, t + ms / 1e3, 1 << 30, 0, 1))
        t += ms / 1e3
    w = Window(setup_s=3.25, start=0.0, end=t, ops=ops)
    read = lambda name: harness.reader("end_to_end", name)(w)  # noqa: E731
    assert read("query_ms_p95") == pytest.approx(2.0)
    assert read("scan_GBps") == pytest.approx(100 * (1 << 30) / t / 1e9)
    assert read("ingest_GBps") == read("scan_GBps")
    assert read("setup_s") == 3.25
    assert harness.reader("end_to_end", "scan_GBps")(Window(setup_s=1.0)) is None
