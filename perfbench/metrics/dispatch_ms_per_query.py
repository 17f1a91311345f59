"""Host time a query spends in the port outside the counts' readback: over
the port's ``amt.api.count_matches`` spans that start in the traced window,
their summed length less the part of it that ``amt.readback`` spans cover
(the copy of the per-stream counts, which waits for the kernel), over
their number, in ms.  None where the trace has no such span."""

import bisect

from perfbench.tracing import union


def read(run):
    w = run.trace.window()
    if w is None:
        return None
    lo, hi = w
    calls = [(a, b) for a, b in run.trace.spans.get("amt.api.count_matches", []) if lo <= a < hi]
    if not calls:
        return None
    readback = union(run.trace.spans.get("amt.readback", []))
    starts = [x for x, _ in readback]
    total = 0.0
    for a, b in calls:
        total += b - a
        i = max(0, bisect.bisect_right(starts, a) - 1)
        while i < len(readback) and readback[i][0] < b:
            x, y = readback[i]
            total -= max(0.0, min(b, y) - max(a, x))
            i += 1
    return total / len(calls) / 1e3
