"""Protocol-compatible count-matches benchmark binary of the port.

Usage: ``python -m alfred_margaret_tpu_torch.bench.countmatches [--device cuda|cpu] FILE...``

Per the reference protocol (``benchmark/benchmark.py:10-24``): for each input
file print tab-separated nanoseconds per round (trailing tab) on stdout, one
line per file, and the match count once on stderr. Timing includes automaton
construction, like the reference's Haskell bench bin
(``benchmark/haskell/app/Main.hs:59-76``), and the engine's: a round on the
card also pays the host-to-device copy of its file, and the first round of a
process the load of the kernel library.

The counterpart of ``alfred_margaret_tpu/bench/countmatches.py``.  It reads
``AMT_ENGINE`` as ``utils.config`` does (the port's names, and the JAX
package's ``pallas`` as ``device``), and maps each name to a port engine:

  auto    MatchEngine (the bitap engine and its count kernel on the bench
          needles; the python oracle below 4 KiB)
  device  DenseAcEngine (the dense count kernel: the JAX ``pallas`` engine)
  xla     XlaAcEngine (torch gathers, no kernel)
  cpp     CppAcEngine (the host C++ engine)
  python  models.ac.count_matches (the scalar oracle)

Environment knobs:
  AMT_ENGINE   = auto | python | xla | device (or pallas) | cpp   (default auto)
  AMT_ROUNDS   = rounds per file (default 5)

``--device`` is ``cuda`` unless ``cpu`` is asked for; ``cuda`` raises on a
host without a CUDA device, whatever the engine.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from ..models import ac
from ..utils import config
from ..utils.case import CASE_SENSITIVE
from ..utils.device import resolve_device
from .dataformat import parse_bench_file

#: The names ``AMT_ENGINE`` may give: the port's, then their JAX aliases.
ENGINES = ("auto", "python", "xla", "device", "cpp") + tuple(config.ALIASES)


def count_with_engine(needles, haystack_bytes, engine: str, device="cuda") -> int:
    engine = config.engine_name(engine)
    machine = ac.build([(n, ()) for n in needles])
    if engine == "cpp":
        from ..native.cpp_engine import CppAcEngine

        return CppAcEngine(machine).count(haystack_bytes)
    if engine == "device":
        from ..ops.pallas_scan import DenseAcEngine

        return DenseAcEngine(machine, device=device).count(haystack_bytes)
    if engine == "xla":
        from ..ops.xla_scan import XlaAcEngine

        return XlaAcEngine(machine, device=device).count(haystack_bytes)
    if engine == "python":
        return ac.count_matches(machine, haystack_bytes)
    from ..engine import MatchEngine

    return MatchEngine(machine, "auto", device=device).count(haystack_bytes, CASE_SENSITIVE)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    p = argparse.ArgumentParser(prog="count-matches")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("files", nargs="*")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    engine = config.EngineConfig.from_env().engine
    if engine not in ENGINES:
        print(f"unknown AMT_ENGINE {os.environ.get('AMT_ENGINE')!r}", file=sys.stderr)
        return 2
    rounds = max(1, int(os.environ.get("AMT_ROUNDS", "5")))
    total_count = None
    for path in args.files:
        needles, haystack = parse_bench_file(path)
        hay = haystack.encode("utf-8")
        times = []
        count = None
        for _ in range(rounds):
            t0 = time.perf_counter_ns()
            c = count_with_engine(needles, hay, engine, device)
            times.append(time.perf_counter_ns() - t0)
            if count is None:
                count = c
            elif count != c:
                print(f"inconsistent counts: {count} vs {c}", file=sys.stderr)
                return 1
        sys.stdout.write("".join(f"{t}\t" for t in times) + "\n")
        total_count = (total_count or 0) + count
    if total_count is not None:
        print(total_count, file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
