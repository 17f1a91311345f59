"""Run one cell of the port's benchmark once and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, this folder and
``alfred_margaret_tpu_torch``.  The cell is an entry of ``workloads`` in
``BENCHMARK.json``; ``perfbench/harness.py`` finds its configuration, mix
and metrics by name.  Without as many CUDA cards as the cell asks for, the
run fails (exit 2) and prints no result; it never falls back to the CPU.
With ``--trace 0`` the result's metrics are the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics, read from a ``torch.profiler``
trace of the window (``perfbench_out/<cell>.trace.json``).  The numbers
compared to decide ``correct`` are printed beside their limits as the last
lines of standard error and under ``checks``, the result's last key.  A run
whose process holds JAX or the JAX package once its window has closed fails
(exit 3) and prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT  # this folder's modules go by ``perfbench.<name>``


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from perfbench import harness

    cell = harness.load_cell(ROOT, args.workload)
    import torch

    harness.log(f"set-up: torch imported by {time.perf_counter() - T0:.3f} s")
    chips = int(cell.entry["chips"])
    found = torch.cuda.is_available() and torch.cuda.device_count()
    harness.log(f"set-up: cards counted by {time.perf_counter() - T0:.3f} s")
    if not found or found < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = harness.run(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                         device="cuda", t0=T0)
    found = harness.forbidden_modules()
    if found:
        print(f"perfbench: the process holds {', '.join(found)} after the window",
              file=sys.stderr)
        return 3
    for k, v in result["checks"].items():
        print(f"check {k}: {v['value']} (limit {v['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
