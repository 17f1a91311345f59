"""The share of the traced window's host-to-device copy bytes that left
pinned host memory, in %: the bytes of the ``gpu_memcpy`` HtoD events whose
name says ``Pinned`` over the bytes of every HtoD event (the events that
``htod_GBps`` reads).  None where the window holds no HtoD copy."""


def read(run):
    w = run.trace.window()
    if w is None:
        return None
    lo, hi = w
    pinned = total = 0
    for e in run.trace.device:
        name = e.get("name", "")
        if e.get("cat") != "gpu_memcpy" or "HtoD" not in name:
            continue
        if not lo <= float(e["ts"]) < hi:
            continue
        got = e.get("args", {}).get("bytes")
        if got is None:
            return None
        total += int(got)
        if "Pinned" in name:
            pinned += int(got)
    return 100.0 * pinned / total if total > 0 else None
