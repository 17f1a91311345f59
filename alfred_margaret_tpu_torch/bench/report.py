"""Summarize .stats files: mean ± stdev and min of per-run totals
(mirrors ``benchmark/report.py:13-31``: each round's time is summed over
files within one run; statistics aggregate over all runs and rounds).  The
port's copy of ``alfred_margaret_tpu/bench/report.py``."""

from __future__ import annotations

import statistics
import sys


def summarize(path: str) -> str:
    with open(path) as f:
        content = f.read()
    # Runs are separated by blank lines (driver.py); within a run, one line
    # per file, one tab-separated ns value per round.
    blocks = [b for b in content.split("\n\n") if b.strip()]
    totals = []
    for block in blocks:
        times = [
            [int(t) for t in line.split("\t") if t]
            for line in block.split("\n")
            if line.strip()
        ]
        if not times:
            continue
        n_rounds = min(len(t) for t in times)
        totals.extend(sum(t[i] for t in times) / 1e9 for i in range(n_rounds))
    if not totals:
        return f"{path}: no timing data"
    mean = statistics.mean(totals)
    stdev = statistics.stdev(totals) if len(totals) > 1 else 0.0
    return f"{path}: mean {mean:.3f} ± {stdev:.3f} s, min {min(totals):.3f} s"


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    for path in argv:
        print(summarize(path))


if __name__ == "__main__":
    main()
