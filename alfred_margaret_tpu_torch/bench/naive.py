"""Naive str.find baseline (mirrors ``benchmark/naive.py``): counts all
occurrences per needle, overlapping only via start+1 restarts.  The port's
copy of ``alfred_margaret_tpu/bench/naive.py``."""

from __future__ import annotations

import sys
import time

from .dataformat import parse_bench_file


def count_naive(needles, haystack: str) -> int:
    total = 0
    for needle in needles:
        if not needle:
            continue
        start = 0
        while True:
            i = haystack.find(needle, start)
            if i < 0:
                break
            total += 1
            start = i + 1
    return total


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    rounds = 5
    total_count = None
    for path in argv:
        needles, haystack = parse_bench_file(path)
        times = []
        count = None
        for _ in range(rounds):
            t0 = time.perf_counter_ns()
            c = count_naive(needles, haystack)
            times.append(time.perf_counter_ns() - t0)
            count = c
        sys.stdout.write("".join(f"{t}\t" for t in times) + "\n")
        total_count = (total_count or 0) + count
    if total_count is not None:
        print(total_count, file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
