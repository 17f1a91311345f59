"""A closed loop of one client: it calls ``call(d)`` on document ``d = i
mod len(sizes)`` back to back, and the window closes with the first
operation to end ``seconds`` or more after it opened."""

import time

from perfbench.tracing import span as open_span


def drive(call, sizes, seconds, span, window):
    n_docs = len(sizes)
    with open_span("window"):
        window.start = t = time.perf_counter()
        i = 0
        while t - window.start < seconds:
            d = i % n_docs
            with open_span(span):
                t0 = time.perf_counter()
                got = call(d)
                t = time.perf_counter()
            window.record(t0, t, sizes[d], d, got)
            i += 1
        window.end = t
