"""Host-to-device copy bytes of the traced window over the device time of
those copies, in GB/s (10^9 bytes)."""


def read(run):
    lo, hi = run.trace.window()
    n_bytes, us = 0, 0.0
    for e in run.trace.device:
        if e.get("cat") != "gpu_memcpy" or "HtoD" not in e.get("name", ""):
            continue
        if not lo <= float(e["ts"]) < hi:
            continue
        got = e.get("args", {}).get("bytes")
        if got is None:
            return None
        n_bytes += int(got)
        us += float(e["dur"])
    return n_bytes / (us * 1e-6) / 1e9 if us > 0 else None
