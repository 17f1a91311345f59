"""CUDA kernel launches of the port per operation: the ``amt.launch``
spans that start in the traced window over the window's operations.  It
reads ``launches_per_op.resident`` (resident queries, moving
``scan_GBps``) and ``launches_per_op.ingest`` (one-shot counts, moving
``ingest_GBps``) alike.  None where the trace has no such span."""


def read(run):
    w = run.trace.window()
    if w is None or not run.window.ops:
        return None
    lo, hi = w
    n = sum(1 for a, _ in run.trace.spans.get("amt.launch", []) if lo <= a < hi)
    return n / len(run.window.ops) if n else None
