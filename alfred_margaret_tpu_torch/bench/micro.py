"""Microbenchmark matrix — the criterion suite equivalent (bench/bm/Main.hs:21-56).

Five needle/haystack scenarios crossed with implementations:

  ac       AC Searcher count (CaseSensitive), on ``--device``
  ac-ci    AC Searcher count (IgnoreCase), on ``--device``
  ac-multi AC with all case variants of the needle (needleCasings — the
           reference's AhoCI-multineedle comparison, Automaton.hs:562-566)
  bm       Boyer-Moore single-needle count (scalar reference impl)
  bm-ci    case-insensitive Boyer-Moore
  bm-ci-classic  the genuine backwards skip-table scan
  nfa      independent runtime-failure-link NFA oracle (conformance impl)
  py-count Python str.count (non-overlapping, the stdlib baseline)
  py-in    Python "in" (existence only)

Automaton build is hoisted out of the timed loop like the reference's
NOINLINE toplevel automata (bench/bm/Main.hs:59-70).  Prints one JSON line
per (scenario, impl) with ns/op and MB/s.  The counterpart of
``alfred_margaret_tpu/bench/micro.py``: the ``ac`` rows run on the card
unless ``--device cpu`` is given (each haystack is about 11 KiB, above the
4 KiB under which ``"auto"`` takes the scalar oracle, so ``ac`` launches
the bitap count kernel).

    python -m alfred_margaret_tpu_torch.bench.micro [--device cpu]
"""

from __future__ import annotations

import argparse
import json

from ..boyer_moore import automaton as bm
from ..boyer_moore_ci import automaton as bmci
from ..models import ac
from ..models.nfa_oracle import NfaOracle
from ..searcher import Searcher
from ..utils.case import CASE_SENSITIVE, IGNORE_CASE
from .timing import best_of


def scenarios():
    base = "Lorem ipsum dolor sit amet, consectetur adipiscing elit. "
    return [
        ("ascii-hit", "dolor", base * 200),
        ("ascii-miss", "zebra", base * 200),
        ("unicode", "naïve", ("attaque naïve à Zürich — ♚ " * 150)),
        ("long-needle", "consectetur adipiscing", base * 200),
        ("many-hits", "it", base * 200),
    ]


def timed(fn, min_rounds=5):
    return best_of(fn, rounds=min_rounds)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="micro")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    device = p.parse_args(argv).device
    for name, needle, hay in scenarios():
        hay_bytes = len(hay.encode())
        s_cs = Searcher.build(CASE_SENSITIVE, [needle], device=device)
        s_ci = Searcher.build(IGNORE_CASE, [needle.lower()], device=device)
        # needleCasings is exponential in cased characters (2^n variants);
        # only bench it on short needles, like the reference's criterion
        # scenarios (bench/bm/Main.hs:21-56).
        n_cased = sum(1 for c in needle if c.lower() != c.upper())
        s_multi = (
            Searcher.build(CASE_SENSITIVE, ac.needle_casings(needle.lower()), device=device)
            if n_cased <= 8
            else None
        )
        bm_auto = bm.build_automaton(needle)
        bmci_auto = bmci.build_automaton(needle.lower())
        nfa = NfaOracle([needle])

        impls = {
            "ac": lambda: s_cs.count_matches(hay),
            "ac-ci": lambda: s_ci.count_matches(hay),
            **(
                {"ac-multi": lambda: s_multi.count_matches(hay)}
                if s_multi is not None
                else {}
            ),
            "bm": lambda: _bm_count(bm_auto, hay),
            "bm-ci": lambda: _bmci_count(bmci_auto, hay),
            "bm-ci-classic": lambda: len(bmci.matches_classic(bmci_auto, hay)),
            "nfa": lambda: nfa.count(hay),
            "py-count": lambda: hay.count(needle),
            "py-in": lambda: needle in hay,
        }
        for impl, fn in impls.items():
            t = timed(fn)
            print(
                json.dumps(
                    {
                        "scenario": name,
                        "impl": impl,
                        "ns_per_op": round(t * 1e9, 1),
                        "mb_per_sec": round(hay_bytes / t / 1e6, 2) if t else None,
                        "result": fn(),
                    }
                ),
                flush=True,
            )
    return 0


def _bm_count(auto, hay):
    n = [0]

    def on_match(_acc, _m):
        n[0] += 1
        return ac.Step(None)

    bm.run_text(None, on_match, auto, hay)
    return n[0]


def _bmci_count(auto, hay):
    n = [0]

    def on_match(_acc, _first, _last):
        n[0] += 1
        return ac.Step(None)

    bmci.run_text(None, on_match, auto, hay)
    return n[0]


if __name__ == "__main__":
    raise SystemExit(main())
