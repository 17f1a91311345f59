"""The traced window: the benchmark's own spans, the profiler, and the
arithmetic over the Chrome trace that the per-layer readers share.

The profiler runs over the measured window alone.  The benchmark opens a
``torch.profiler.record_function`` span named
``window`` around the measured loop and one per operation (the operation
file's ``SPAN``: ``query`` for a resident count, ``ingest`` for a one-shot
count); the profiler records the
CPU ops and every kernel, copy and memset of the process's CUDA context,
the port's ``ctypes``-launched kernels included.  Busy time is the union of
the device intervals: the arithmetic of
``alfred_margaret_tpu_torch/utils/trace.py:device_idle_share``,
copied here so that the yardstick does not move with the program.
"""

from __future__ import annotations

import bisect
import contextlib
import json
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import torch

#: Chrome-trace categories of device work: kernels, copies and memsets.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")

Interval = Tuple[float, float]


@contextlib.contextmanager
def profiled(path: Optional[str]) -> Iterator[None]:
    """Run the block under ``torch.profiler`` (CPU and, where CUDA is
    initialised, CUDA activity) and write its Chrome trace to ``path``; do
    nothing when ``path`` is None."""
    if path is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(path)


def span(name: str):
    """A span of the benchmark's own, recorded when the profiler runs."""
    return torch.profiler.record_function(name)


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """The disjoint union of ``intervals``, in order."""
    out: List[Interval] = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


class Trace:
    """A Chrome trace written by :func:`profiled`; times in microseconds."""

    def __init__(self, events: Sequence[dict]):
        xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
        self.device = [e for e in xs if e.get("cat") in DEVICE_CATEGORIES]
        self.spans: Dict[str, List[Interval]] = {}
        for e in xs:
            if e.get("cat") == "user_annotation":
                a = float(e["ts"])
                self.spans.setdefault(e["name"], []).append((a, a + float(e["dur"])))
        for v in self.spans.values():
            v.sort()
        self.cpu_ops = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                              for e in xs if e.get("cat") == "cpu_op")
        self._busy = {}

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            return cls(json.load(f)["traceEvents"])

    def window(self) -> Optional[Interval]:
        """The ``window`` span, or None where the trace has none."""
        w = self.spans.get("window")
        return w[0] if w else None

    def busy_intervals(self, cats: Sequence[str] = DEVICE_CATEGORIES) -> List[Interval]:
        key = tuple(cats)
        if key not in self._busy:
            self._busy[key] = union((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                                    for e in self.device if e.get("cat") in cats)
        return self._busy[key]

    def busy(self, lo: float, hi: float, cats: Sequence[str] = DEVICE_CATEGORIES) -> float:
        """Microseconds of ``[lo, hi)`` in which a device event of ``cats`` ran."""
        ivs = self.busy_intervals(cats)
        i = max(0, bisect.bisect_right(ivs, (lo, float("inf"))) - 1)
        total = 0.0
        for a, b in ivs[i:]:
            if a >= hi:
                break
            total += max(0.0, min(b, hi) - max(a, lo))
        return total

    def idle_gaps(self, lo: float, hi: float) -> List[Interval]:
        """The stretches of ``[lo, hi)`` in which no device event ran."""
        gaps, t = [], lo
        for a, b in self.busy_intervals():
            if b <= lo:
                continue
            if a >= hi:
                break
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if t < hi:
            gaps.append((t, hi))
        return gaps

    def host_label(self, t: float) -> str:
        """What the host was doing at ``t``: the benchmark's innermost span
        open then, other than ``window`` (``loop`` where none is), and the
        innermost CPU op inside it (``python`` where none is)."""
        name, opened = "loop", None
        for s, ivs in self.spans.items():
            i = bisect.bisect_right(ivs, (t, float("inf"))) - 1
            if s != "window" and i >= 0 and ivs[i][1] > t and (
                    opened is None or ivs[i][0] >= opened):
                name, opened = s, ivs[i][0]
        op, i = "python", bisect.bisect_right(self.cpu_ops, (t, float("inf"), "")) - 1
        best = None
        for a, b, nm in self.cpu_ops[max(0, i - 64) : i + 1]:
            if a <= t < b and (best is None or a >= best[0]):
                best = (a, nm)
        if best is not None:
            op = best[1]
        return f"{name}:{op}"

    def device_ops(self, lo: float, hi: float, top: int = 10) -> List[list]:
        """The ``top`` device operations by their seconds inside ``[lo, hi)``."""
        by_name: Dict[str, float] = {}
        for e in self.device:
            a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            d = min(b, hi) - max(a, lo)
            if d > 0:
                by_name[e["name"]] = by_name.get(e["name"], 0.0) + d
        rank = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        return [[name, us * 1e-6] for name, us in rank]

    def idle_breakdown(self, lo: float, hi: float, top: int = 10) -> List[list]:
        """Idle seconds inside ``[lo, hi)`` by what the host was doing at
        each gap's middle, the ``top`` largest."""
        by_label: Dict[str, float] = {}
        for a, b in self.idle_gaps(lo, hi):
            label = self.host_label((a + b) / 2)
            by_label[label] = by_label.get(label, 0.0) + (b - a)
        rank = sorted(by_label.items(), key=lambda kv: -kv[1])[:top]
        return [[label, us * 1e-6] for label, us in rank]


__all__ = ["DEVICE_CATEGORIES", "Trace", "profiled", "span", "union"]
