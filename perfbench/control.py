"""The control of ``correct``: how far the reference, with one guarantee
broken, lands from the sound reference on a cell's own data.

    python3 perfbench/control.py --workload <name> --seeds 1,2,3 [--cut 4096]

For each seed it makes the cell's documents as a run does and prints, for
each document, the sound count and the control's count: the reference
computed in independent blocks of ``--cut`` bytes, which loses every
occurrence across a block's end (the fault of a scan that drops its warm-up
or its chunk prefix).  The largest gap on any seed is the control's reading
of ``max_abs_err``, whose limit is 0.  The benchmark's own runs never run
this; it imports nothing of the program.
"""

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--cut", type=int, default=4096)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from perfbench import harness, reference

    cell = harness.load_cell(ROOT, args.workload)
    needles = [n.encode() for n in cell.config["needles"]]
    readings = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        docs = harness.make_documents(cell, seed, args.device)
        sound = [reference.count(d, needles, args.device) for d in docs]
        broken = [reference.count(d, needles, args.device, cut=args.cut) for d in docs]
        gap = max(abs(a - b) for a, b in zip(sound, broken))
        readings.append(gap)
        print(f"control {args.workload} seed {seed}: sound {sound} control {broken} "
              f"max_abs_err {gap} ({time.perf_counter() - t:.1f} s)", flush=True)
    print(f"control {args.workload}: least max_abs_err over {len(readings)} seeds "
          f"{min(readings)} (limit 0)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
