"""Benchmark driver (reference-protocol compatible).

Mirrors ``benchmark/benchmark.py``: runs a program 5x over the data files,
asserts match counts identical across runs, writes ``$prefix.stats`` (raw
tab-separated ns) and ``$prefix.results`` (counts). The reference pins to a
CPU core and demands the performance governor; for a program whose scans
run on a GPU that gate does not apply, but count cross-checking between
engines/programs is kept as the conformance protocol.  The port's copy of
``alfred_margaret_tpu/bench/driver.py``.

Usage: ``python -m alfred_margaret_tpu_torch.bench.driver PROGRAM --prefix NAME
[--data-directory DIR] [--runs N]``, for example with ``PROGRAM`` =
``"python -m alfred_margaret_tpu_torch.cli count-matches"``
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys


def run_benchmark(program: str, prefix: str, data_directory: str = "data", runs: int = 5):
    input_files = sorted(
        os.path.abspath(os.path.join(data_directory, f))
        for f in os.listdir(data_directory)
        if f.endswith(".txt")
    )
    print(f"Found {len(input_files)} files to benchmark.")
    cmdline = program.split() + input_files

    all_stats = []
    counts = None
    for run in range(runs):
        proc = subprocess.run(cmdline, capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stderr, file=sys.stderr)
            raise RuntimeError(f"{program} failed with {proc.returncode}")
        # Blank line between runs so report.py can sum per run over files.
        all_stats.append(proc.stdout if proc.stdout.endswith("\n") else proc.stdout + "\n")
        all_stats.append("\n")
        # The protocol puts the count on stderr's LAST line; incidental
        # logging (e.g. backend warnings) above it must not break the
        # cross-run consistency check.
        err_lines = proc.stderr.strip().splitlines()
        run_counts = err_lines[-1] if err_lines else ""
        if counts is None:
            counts = run_counts
        elif counts != run_counts:
            raise RuntimeError(
                f"match counts differ between runs: {counts!r} vs {run_counts!r}"
            )
        print(f"run {run}: ok")

    with open(f"{prefix}.stats", "w") as f:
        f.writelines(all_stats)
    with open(f"{prefix}.results", "w") as f:
        f.write((counts or "") + "\n")
    print(f"wrote {prefix}.stats / {prefix}.results (counts: {counts})")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("program")
    p.add_argument("--prefix", required=True)
    p.add_argument("--data-directory", default="data")
    p.add_argument("--runs", type=int, default=5)
    a = p.parse_args(argv)
    run_benchmark(a.program, a.prefix, a.data_directory, a.runs)


if __name__ == "__main__":
    main()
