"""End-to-end serving walkthrough of the port — on the card, or the CPU.

The counterpart of ``examples/serving_demo.py``: the production patterns
over one resident corpus: build -> stage once -> repeated device-resident
scans -> live needle-set swap (adopt_staged) -> IgnoreCase -> priority
replacement -> splitting -> staged replacement and screened containsAny ->
a mesh of four shards of the chosen device.  Every step asserts exactness
against the scalar oracle (or a fixed answer), so this file is also an
acceptance script:

    python -m alfred_margaret_tpu_torch.examples.serving_demo              # the card
    python -m alfred_margaret_tpu_torch.examples.serving_demo --device cpu
"""

from __future__ import annotations

import argparse
import time

from alfred_margaret_tpu_torch import (
    CASE_SENSITIVE,
    IGNORE_CASE,
    Replacer,
    Searcher,
    Splitter,
)
from alfred_margaret_tpu_torch.bench.dataformat import synth_corpus
from alfred_margaret_tpu_torch.models import ac
from alfred_margaret_tpu_torch.parallel import make_mesh

MB = 1 << 20


def step(msg, t0):
    print(f"  [{time.perf_counter() - t0:6.2f}s] {msg}", flush=True)


def main(device="cuda", corpus_bytes: int = 8 * MB) -> None:
    t0 = time.perf_counter()
    needles = ["tshirt", "shirts", "shorts", "hoodie"]
    corpus = synth_corpus(needles[:3], corpus_bytes, hit_fraction=0.01, seed=42)
    oracle = ac.build([(n, i) for i, n in enumerate(needles)])
    expected = ac.count_matches(oracle, corpus)

    # 1. Build + stage once, scan many times.
    s = Searcher.build_needle_id_searcher(CASE_SENSITIVE, needles, device=device)
    staged = s.stage(corpus)
    for _ in range(3):
        assert s.count_matches(staged) == expected
    step(f"staged scans: {expected} matches x3, exact", t0)

    # 2. Live needle-set swap: the corpus stays resident.
    s2 = Searcher.build_needle_id_searcher(CASE_SENSITIVE, ["short", "tshir"], device=device)
    staged2 = s2.adopt_staged(staged)
    expected2 = s2.count_matches(bytes(corpus))
    assert s2.count_matches(staged2) == expected2
    step(f"needle-set swap via adopt_staged: {expected2} matches, exact", t0)

    # 3. IgnoreCase on raw bytes.  Reference contract: the caller passes
    # LOWERCASE needles under IgnoreCase (Searcher.hs:108-110); STRASSE does
    # not match straße (simple per-code-point lowering, not full case
    # folding — ß stays ß).
    s_ci = Searcher.build_needle_id_searcher(IGNORE_CASE, ["tshirt", "straße"], device=device)
    hay_ci = "TSHIRT tshirt STRASSE straße İ " * 1000
    got_ci = s_ci.count_matches(hay_ci)
    assert got_ci == 3000, got_ci  # 2x tshirt + 1x straße per repeat
    step(f"IgnoreCase scan: {got_ci} matches, raw coordinates", t0)

    # 4. Priority replacement (bit-exact multi-pass semantics).
    r = Replacer.build(CASE_SENSITIVE, [("tshirt", "TEE"), ("shirts", "S")], device=device)
    out = r.run("tshirts and shirts")
    assert out == "TEEs and S", out
    step(f"replacer: {out!r}", t0)

    # 5. Splitting.
    frags = Splitter.build(", ", device=device).split("a, b, c")
    assert frags == ["a", "b", "c"]
    step(f"splitter: {frags}", t0)

    # 5b. Staged replacement (one resident corpus feeds search AND replace)
    # and screened containsAny (a fire-free corpus answers from the
    # stride-2 filter alone; candidate fires fall back to the exact scan —
    # verdicts exact either way).
    rep_pairs = [("tshirt", "TEE"), ("shirts", "S")]
    r5 = Replacer.build(CASE_SENSITIVE, rep_pairs, device=device)
    corpus_b = "tshirts and shirts " * 2000
    staged_r = r5.searcher.stage(corpus_b)
    assert r5.run(staged_r) == r5.run(corpus_b).encode()  # staged in, bytes out
    step("staged replacer: bit-exact against the bytes path", t0)
    screen_corpus = "0123456789 ,;:! " * 20000  # alphabet-disjoint
    many = ["needle%02da" % i for i in range(40)]  # mid-tier: comb16 + filter
    s_mid = Searcher.build(CASE_SENSITIVE, many, device=device)
    assert s_mid.contains_any(s_mid.stage(screen_corpus)) is False
    assert s_mid.contains_any(screen_corpus[:500] + many[3] + screen_corpus[500:])
    step("screened containsAny: fire-free corpus answered by the filter alone", t0)

    # 6. A mesh of four shards of the device (on one card they take turns
    # on it; several cards each take their own shards the same way).
    mesh = make_mesh([s.device] * 4, data=4)
    dist = s.distributed(mesh, inner="pallas")
    assert dist.count(corpus) == expected
    step(f"mesh count over {mesh.devices.size} shards of {s.device}: exact", t0)

    print("serving demo: ALL STEPS EXACT")


if __name__ == "__main__":
    p = argparse.ArgumentParser(prog="serving_demo")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--mb", type=int, default=8, help="corpus MiB")
    a = p.parse_args()
    main(a.device, a.mb * MB)
