"""``split_copy_pct`` on small synthetic Chrome traces: of the union of the
window's ``amt.stage.host`` spans, the share that ``amt.stage.host.split``
spans cover; spans clipped to the window, overlaps counted once, and None
where the window holds no split span (a program that never copies on the
intra-op threads)."""

import pytest

from perfbench import harness
from perfbench.harness import Op, TracedRun, Window
from perfbench.tracing import Trace


def _x(name, ts, dur, cat="user_annotation"):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def _read(events):
    window = Window(setup_s=1.0, start=0.0, end=1.0, ops=[Op(0.0, 1.0, 1000, 0, 1)])
    run = TracedRun(trace=Trace(events), window=window, kind="Card", peaks={})
    return harness.reader("metrics", "split_copy_pct")(run)


WINDOW = _x("window", 100, 1000)  # [100, 1100)
HOST, SPLIT = "amt.stage.host", "amt.stage.host.split"


def test_share_of_host_copy_time_split():
    assert _read([
        WINDOW,
        _x(HOST, 150, 100), _x(SPLIT, 160, 80),  # a split slice: 80 of 100 us
        _x(HOST, 300, 100),  # an unsplit slice (a short tail)
        _x(HOST, 500, 200), _x(HOST, 600, 200),  # overlapping: [500, 800) once
        _x(SPLIT, 520, 60), _x(SPLIT, 650, 100),  # 160 us of it
        _x(HOST, 1050, 100), _x(SPLIT, 1060, 80),  # 50 us host, 40 split inside
        _x(HOST, 20, 60), _x(SPLIT, 30, 40),  # before the window
    ]) == pytest.approx(100 * (80 + 160 + 40) / (100 + 100 + 300 + 50))


def test_every_copy_split():
    events = [WINDOW]
    for t in range(200, 1000, 100):
        events += [_x(HOST, t, 50), _x(SPLIT, t + 1, 48)]
    assert _read(events) == pytest.approx(100 * 48 / 50)


@pytest.mark.parametrize("events", [
    [WINDOW, _x(HOST, 200, 100), _x(HOST, 400, 100)],  # the parent: no split span
    [WINDOW, _x(HOST, 200, 100), _x(SPLIT, 1200, 10)],  # split spans outside the window
    [WINDOW, _x("ingest", 200, 300)],  # no host copy at all
    [_x(HOST, 200, 100), _x(SPLIT, 210, 80)],  # no window
], ids=["no_split_span", "split_outside", "no_host_span", "no_window"])
def test_nothing_to_read(events):
    assert _read(events) is None
