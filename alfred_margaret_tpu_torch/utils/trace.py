"""Tracing / profiling / observability helpers of the port.

The counterpart of ``alfred_margaret_tpu/utils/trace.py``, on
``torch.profiler`` in place of ``jax.profiler``:

* :func:`profile` — context manager around any scan.  With a trace dir the
  block runs under ``torch.profiler.profile`` (CPU activity, and CUDA
  activity once CUDA is initialised, which records every kernel and copy of
  the process's CUDA context, the ``ctypes``-launched kernels included) in a
  ``record_function(label)`` span, and a Chrome trace JSON is written into
  the dir.  Wall time + bytes/s are always recorded; once CUDA is
  initialised the clock stops after ``torch.cuda.synchronize()``, so the
  wall covers the device's work.
* :class:`ScanStats` — per-engine counters (bytes scanned, scans, wall
  seconds) that high-level code can aggregate and export (the original's,
  statement for statement).
* :func:`device_idle_share` — read a trace written by :func:`profile`: the
  device's busy time (the union of kernel, copy and memset intervals) over
  the ``label`` span, and its idle share.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass
from typing import Iterator, Optional

import torch


@dataclass
class ScanStats:
    bytes_scanned: int = 0
    scans: int = 0
    seconds: float = 0.0

    @property
    def bytes_per_second(self) -> float:
        return self.bytes_scanned / self.seconds if self.seconds else 0.0

    def record(self, n_bytes: int, seconds: float) -> None:
        self.bytes_scanned += n_bytes
        self.scans += 1
        self.seconds += seconds

    def as_dict(self) -> dict:
        return {
            "bytes_scanned": self.bytes_scanned,
            "scans": self.scans,
            "seconds": round(self.seconds, 6),
            "bytes_per_second": round(self.bytes_per_second, 1),
        }


#: Module-level aggregate, recorded by engines when tracing is enabled.
GLOBAL_STATS = ScanStats()

#: Chrome-trace categories of device work: kernels, copies and memsets.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def profile(
    n_bytes: int,
    label: str = "scan",
    trace_dir: Optional[str] = None,
    stats: Optional[ScanStats] = None,
) -> Iterator[ScanStats]:
    """Time a block, optionally under the torch profiler.

    >>> with profile(len(data), trace_dir="traces") as st:
    ...     searcher.count_matches(data)
    >>> st.bytes_per_second
    """
    local = ScanStats()
    cuda = torch.cuda.is_initialized()
    prof = None
    if trace_dir is not None:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        prof = torch_profile(activities=activities)
    with prof if prof is not None else contextlib.nullcontext():
        t0 = time.perf_counter()  # the profiler's start-up stays out of the wall
        with torch.profiler.record_function(label):
            yield local
            if cuda:
                torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    local.record(n_bytes, dt)
    (stats or GLOBAL_STATS).record(n_bytes, dt)
    if prof is not None:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(
            os.path.join(trace_dir, f"{label}.{os.getpid()}.{time.time_ns()}.json"))


def device_idle_share(path: str, label: str = "scan") -> dict:
    """The device's busy and idle time over the ``label`` span of a Chrome
    trace written by :func:`profile`: ``wall_us`` (the span), ``busy_us``
    (the union of its kernel, copy and memset intervals, clipped to the
    span), ``idle_share`` (``1 - busy / wall``), the number of device
    events by category, and ``top``: the five device event names with the
    most time in the span, ``[name, us]``.  Raises ``ValueError`` without
    the span."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("name") == label and e.get("ph") == "X"
             and e.get("cat") == "user_annotation"]
    if not spans:
        raise ValueError(f"{path}: no {label!r} span")
    lo = min(float(e["ts"]) for e in spans)
    hi = max(float(e["ts"]) + float(e["dur"]) for e in spans)
    counts = {c: 0 for c in DEVICE_CATEGORIES}
    intervals, by_name = [], {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in counts:
            counts[e["cat"]] += 1
            a, b = max(lo, float(e["ts"])), min(hi, float(e["ts"]) + float(e["dur"]))
            if b > a:
                intervals.append((a, b))
                by_name[e["name"]] = by_name.get(e["name"], 0.0) + b - a
    busy, end = 0.0, lo
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    wall = hi - lo
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"wall_us": wall, "busy_us": busy,
            "idle_share": 1.0 - busy / wall if wall > 0 else None, **counts,
            "top": [[name, us] for name, us in top]}


__all__ = ["profile", "ScanStats", "GLOBAL_STATS", "device_idle_share"]
