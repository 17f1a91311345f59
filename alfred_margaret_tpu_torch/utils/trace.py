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
* :func:`span` — the port's own spans at its layer boundaries (names in
  :data:`SPANS`), recorded only while a torch profiler runs: a
  ``record_function`` then, and a shared no-op context otherwise, so that
  an unprofiled call pays one flag check a span.
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

#: Every span the port opens, from the API down to the kernel launch.  The
#: names never nest inside themselves: a trace reader takes the innermost
#: open span by name.
SPANS = (
    # API and dispatch: one span a public call of ``Searcher``.
    "amt.api.stage",
    "amt.api.adopt_staged",
    "amt.api.count_matches",
    "amt.api.contains_any",
    "amt.api.contains_all",
    "amt.api.all_matches",
    "amt.api.all_matches_arrays",
    "amt.prep",  # ``MatchEngine._prep``
    "amt.readback",  # the per-stream counts copied to the host
    "amt.reduce",  # their int64 sum over live streams
    "amt.host_recount",  # a trapped stream recounted, or B1's fallback rescan
    # The needle-grouped engine (``ops/grouped.py``).
    "amt.group.build",  # the partition, the per-group engines and the screen
    "amt.group.fuse",  # a uniform table set for B9 or B11
    "amt.group.pass",  # one count pass over a staging: B9, or one group's own
    "amt.group.screen",  # the suffix screen's count launch, inside its pass
    # Staging and streaming.
    "amt.stream.chunk",  # one chunk of ``StreamingScanner``
    "amt.stream.cold_prefix",  # the host replay of a chunk's W-byte prefix
    "amt.stage",  # ``stage_streams_device``
    "amt.stage.host",  # a host copy or conversion of the text
    "amt.stage.host.split",  # a ring slice's copy on the intra-op threads
    "amt.stage.htod",  # a slice's host-to-device copy enqueued, or a wait on one
    "amt.stage.layout",  # the ``[T, S]`` layout built on the device
    # Kernels.
    "amt.launch",  # ``kernels.common.launch``: one CUDA kernel launch
)

_NO_SPAN = contextlib.nullcontext()
_autograd_profiler = torch.autograd.profiler


def span(name: str):
    """A span named ``name`` (one of :data:`SPANS`): ``record_function``
    while a torch profiler runs, else a shared no-op context."""
    if getattr(_autograd_profiler, "_is_profiler_enabled", False):
        return torch.profiler.record_function(name)
    return _NO_SPAN


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


__all__ = ["profile", "ScanStats", "GLOBAL_STATS", "SPANS", "device_idle_share", "span"]
