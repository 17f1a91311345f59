"""``screen_passes_per_query`` on small synthetic Chrome traces: the
``amt.group.screen`` spans that start in the window over the window's
operations, so 1.0 where the suffix screen counts every query, and None
where the window holds no such span (a program that counts with B9 or the
groups' own passes, or the parent of the screen)."""

import pytest

from perfbench import harness
from perfbench.harness import Op, TracedRun, Window
from perfbench.tracing import Trace


def _x(name, ts, dur, cat="user_annotation"):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def _read(events, n_ops):
    ops = [Op(0.0, 1.0, 1 << 30, 0, 1)] * n_ops
    window = Window(setup_s=1.0, start=0.0, end=1.0, ops=ops)
    run = TracedRun(trace=Trace(events), window=window, kind="Card", peaks={})
    return harness.reader("metrics", "screen_passes_per_query")(run)


WINDOW = _x("window", 100, 1000)  # [100, 1100)
PASS, SCREEN = "amt.group.pass", "amt.group.screen"


def _query(t):
    return [_x("query", t, 150), _x(PASS, t + 10, 100), _x(SCREEN, t + 12, 30),
            _x("screen_count_kernel", t + 20, 80, cat="kernel")]


def test_one_screen_pass_a_query():
    events = [WINDOW, _x(SCREEN, 50, 20)]  # before the window
    for q in range(4):
        events += _query(120 + 200 * q)
    events.append(_x(SCREEN, 1150, 10))  # after the window
    assert _read(events, 4) == pytest.approx(1.0)


@pytest.mark.parametrize("events, n_ops", [
    ([WINDOW] + [_x(PASS, 120 + 200 * q, 100) for q in range(4)], 4),  # B9: a pass, no screen
    ([WINDOW, _x(SCREEN, 1200, 10)], 1),  # a screen span outside the window
    ([_x(SCREEN, 200, 10)], 1),  # no window
    ([WINDOW, _x(SCREEN, 200, 10)], 0),  # no operation
], ids=["b9_route", "outside", "no_window", "no_operation"])
def test_nothing_to_read(events, n_ops):
    assert _read(events, n_ops) is None
