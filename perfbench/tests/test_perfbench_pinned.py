"""``pinned_htod_share`` on small synthetic Chrome traces: the share of the
window's host-to-device copy bytes whose event says ``Pinned``; copies that
start outside the window, and copies in other directions, do not count."""

import pytest

from perfbench import harness
from perfbench.harness import Op, TracedRun, Window
from perfbench.tracing import Trace


def _x(name, ts, dur, cat="user_annotation", **args):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if args:
        e["args"] = args
    return e


def _copy(kind, ts, n_bytes):
    return _x(f"Memcpy {kind}", ts, 10, cat="gpu_memcpy", bytes=n_bytes)


def _read(events):
    window = Window(setup_s=1.0, start=0.0, end=1.0, ops=[Op(0.0, 1.0, 1000, 0, 1)])
    run = TracedRun(trace=Trace(events), window=window, kind="Card", peaks={})
    return harness.reader("metrics", "pinned_htod_share")(run)


WINDOW = _x("window", 100, 1000)  # [100, 1100)


def test_share_of_pinned_bytes_inside_the_window():
    assert _read([
        WINDOW,
        _copy("HtoD (Pageable -> Device)", 200, 1000),
        _copy("HtoD (Pinned -> Device)", 300, 3000),
        _copy("HtoD (Pageable -> Device)", 50, 7000),  # before the window
        _copy("HtoD (Pinned -> Device)", 1100, 9000),  # at its end
        _copy("DtoH (Device -> Pageable)", 400, 5000),  # another direction
        _copy("DtoD (Device -> Device)", 500, 5000),
    ]) == pytest.approx(75.0)


@pytest.mark.parametrize("kind,share", [("HtoD (Pinned -> Device)", 100.0),
                                        ("HtoD (Pageable -> Device)", 0.0)])
def test_one_kind_of_copy(kind, share):
    assert _read([WINDOW, _copy(kind, 200, 4096), _copy(kind, 900, 1)]) == pytest.approx(share)


def test_nothing_to_read():
    # No HtoD copy in the window, no window, a copy without its bytes.
    assert _read([WINDOW, _copy("DtoH (Device -> Pageable)", 200, 100)]) is None
    assert _read([_copy("HtoD (Pinned -> Device)", 200, 100)]) is None
    assert _read([WINDOW, _x("Memcpy HtoD (Pinned -> Device)", 200, 10, cat="gpu_memcpy")]) is None
