"""The host's copies of the text before its host-to-device copy, in GB/s
(10^9 bytes): the document bytes of the window's operations over the
seconds of the union of the port's ``amt.stage.host`` spans inside the
traced window (a chunk's slice, the writable copy before staging).  None
where the trace has no such span."""

from perfbench.tracing import union


def read(run):
    w = run.trace.window()
    if w is None or not run.window.ops:
        return None
    lo, hi = w
    clipped = ((max(a, lo), min(b, hi)) for a, b in run.trace.spans.get("amt.stage.host", []))
    us = sum(b - a for a, b in union(clipped))
    if us <= 0:
        return None
    return sum(op.n_bytes for op in run.window.ops) / (us * 1e-6) / 1e9
