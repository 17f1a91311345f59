"""The readers of the port's own spans (``amt.*``, recorded by
``alfred_margaret_tpu_torch/utils/trace.py:span`` under the profiler) on
small synthetic Chrome traces: only spans that start inside the window
count, the counts' readback is taken out only where it covers a query,
overlapping host copies count once, and every reader gives None where the
trace has none of its spans (a program without them)."""

import pytest

from perfbench import harness
from perfbench.harness import Op, TracedRun, Window
from perfbench.tracing import Trace

READERS = ("dispatch_ms_per_query", "launch_us", "launches_per_op.resident",
           "launches_per_op.ingest", "host_copy_GBps")


def _x(name, ts, dur, cat="user_annotation"):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def _run(events, n_ops=2, n_bytes=1_000_000):
    ops = [Op(0.0, 1.0, n_bytes, 0, 1) for _ in range(n_ops)]
    window = Window(setup_s=1.0, start=0.0, end=1.0, ops=ops)
    return TracedRun(trace=Trace(events), window=window, kind="Card", peaks={})


def _read(name, run):
    return harness.reader("metrics", name)(run)


WINDOW = _x("window", 100, 1000)  # [100, 1100)


def test_launches_outside_the_window_do_not_count():
    run = _run([WINDOW, _x("amt.launch", 50, 40), _x("amt.launch", 200, 10),
                _x("amt.launch", 600, 30), _x("amt.launch", 1100, 90),
                _x("bitap_count_kernel", 210, 300, cat="kernel")])
    assert _read("launch_us", run) == pytest.approx(20.0)
    assert _read("launches_per_op.resident", run) == pytest.approx(1.0)
    assert _read("launches_per_op.ingest", run) == pytest.approx(1.0)
    run.window.ops = run.window.ops[:1] * 34
    assert _read("launches_per_op.ingest", run) == pytest.approx(2 / 34)


def test_readback_is_taken_out_only_where_it_covers_a_query():
    run = _run([
        WINDOW,
        _x("amt.api.count_matches", 50, 40),  # starts before the window
        _x("amt.api.count_matches", 100, 400),
        _x("amt.api.count_matches", 600, 400),
        _x("amt.readback", 300, 100),  # inside the first query
        _x("amt.readback", 520, 60),  # between the queries
        _x("amt.readback", 950, 100),  # half inside the second
        _x("amt.readback", 960, 20),  # inside the one above: counted once
    ])
    assert _read("dispatch_ms_per_query", run) == pytest.approx(((400 - 100) + (400 - 50)) / 2e3)


def test_dispatch_without_readback_is_the_whole_call():
    run = _run([WINDOW, _x("amt.api.count_matches", 200, 300)])
    assert _read("dispatch_ms_per_query", run) == pytest.approx(0.3)


def test_overlapping_host_copies_count_once():
    run = _run([
        WINDOW,
        _x("amt.stage.host", 20, 60),  # before the window
        _x("amt.stage.host", 150, 200),  # [150, 350)
        _x("amt.stage.host", 250, 200),  # [250, 450): 100 us more
        _x("amt.stage.host", 300, 20),  # inside both
        _x("amt.stage.host", 700, 100),
        _x("amt.stage.host", 1050, 150),  # 50 us inside the window
    ], n_ops=2, n_bytes=225_000)
    # 450 000 bytes over 450 us.
    assert _read("host_copy_GBps", run) == pytest.approx(1.0)


@pytest.mark.parametrize("name", READERS)
def test_no_span_no_number(name):
    parent = [WINDOW, _x("query", 120, 300), _x("ingest", 500, 300),
              _x("aten::copy_", 130, 50, cat="cpu_op"),
              _x("bitap_count_kernel", 200, 100, cat="kernel")]
    assert _read(name, _run(parent)) is None
    # Spans outside the window alone: nothing to read either.
    outside = parent + [_x(s, 1200, 10) for s in ("amt.launch", "amt.api.count_matches",
                                                  "amt.readback", "amt.stage.host")]
    assert _read(name, _run(outside)) is None
    # No window at all.
    assert _read(name, _run([_x("amt.launch", 10, 5)])) is None
