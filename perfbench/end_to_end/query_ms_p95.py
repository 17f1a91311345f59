"""The 95th percentile, in ms, of every query of the window, each from the
call until its count is on the host."""

from perfbench.stats import percentile


def read(window):
    if not window.ops:
        return None
    return percentile([(op.end - op.start) * 1e3 for op in window.ops], 95)
