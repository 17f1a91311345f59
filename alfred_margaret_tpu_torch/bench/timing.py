"""Shared timing helper for the bench modules (the port's copy of
``alfred_margaret_tpu/bench/timing.py``)."""

from __future__ import annotations

import time


def best_of(fn, rounds: int = 3) -> float:
    """Best wall time over ``rounds`` calls, after one untimed warm-up."""
    fn()
    best = float("inf")
    for _ in range(rounds):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best
