"""The mean length of the port's kernel launches on the host, in us: the
``amt.launch`` spans (``kernels/common.py:launch``: the library's load,
the device context and the ``ctypes`` call) that start in the traced
window.  None where the trace has no such span."""


def read(run):
    w = run.trace.window()
    if w is None:
        return None
    lo, hi = w
    spans = [b - a for a, b in run.trace.spans.get("amt.launch", []) if lo <= a < hi]
    return sum(spans) / len(spans) if spans else None
