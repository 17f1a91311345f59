"""Drive the PyTorch port's Searcher once on one NVIDIA GPU.

Run from the repository root on a host with one CUDA card (an H100):

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``alfred_margaret_tpu_torch/csrc``
(one ``nvcc`` per source, all at once) and checks each of the seventeen
kernels against its plain torch version on the card on nineteen machines, and
the trap parts of B2, B4 and B7 on three IgnoreCase layouts, and the
engines' answers (``final_states`` and the extraction without the host
corpus too) against the port's host C++ engine.  Then it drives nine main
paths, each with the kernels' launch counts set to 0 just before it and read
just after (the controls' launches are read apart), the first seven over
128 MiB corpora:

* the benchmark's 3 needles (``bench.py``): ``stage`` -> ``count_matches``
  (B2, and B1 as the dense control), ``contains_any`` on a hit and a miss
  (B4; B3 in four segments as the dense control), ``contains_all`` true and
  false (B7; B6 as the dense control) and ``all_matches_arrays`` (B6 with its
  bitap and its dense step);
* 30 random needles, which the dispatcher sends to the dense engine:
  ``stage`` -> ``count_matches`` (B1), ``contains_any`` (B3),
  ``contains_all`` and ``all_matches_arrays`` (B6 with its dense step);
* ``BASELINE.json`` config 2's 100 needles on the comb16 engine: ``stage`` ->
  ``count_matches`` (B8), ``contains_any`` through the stride-2 screen (B14)
  on a short-needle hit, a corpus on which no chain fires, and the digits
  corpus of config 2b with and without one needle in it, where the sticky
  scan (B10) decides; the same with ``AMT_FILTER=0`` as the control;
  ``contains_all`` true and false and ``all_matches_arrays`` (B6 with the
  comb16 step, B13);
* ``BASELINE.json`` config 5's first 300 needles, which overflow comb16, on
  the comb32 engine: ``stage`` -> ``count_matches`` (B15), ``contains_any``
  on the config-5 corpus, the digits corpus and the digits corpus with one
  needle in it (B16), ``contains_all`` true and false and
  ``all_matches_arrays`` (B15, then B17);
* ``BASELINE.json`` config 5's first 1,000 needles, which no single-pass
  engine holds, on the needle-grouped engine (seven comb32 groups and one
  comb16 group, as in the JAX package): ``stage`` -> ``count_matches`` (B9,
  one launch over the uniform groups), ``contains_any`` through the 12-word
  screen (B14) and then B11 on the config-5 corpus, a fire-free corpus, the
  digits corpus and the digits corpus with one needle of the last group;
  ``contains_all`` true and false and ``all_matches_arrays`` (B15 and B17 for
  each comb32 group, B13 for the comb16 group); with ``AMT_FUSED_GROUPS=0``
  (per-group B15, B16, B8 and B10) and ``AMT_FILTER=0`` (B11 alone) as the
  controls;
* per-position states: ``final_states_staged`` on the bench needles (B5 on
  the bitap engine's dense tables), the 30 dense needles (B5), config 2
  (B12) and config 5's first 300 (B17), each equal to the host C++ engine's
  ``final_states``;
* extraction through the packed states, on stagings without their host
  corpus: the 30 dense needles (B1, then B5), config 2 (B8, then B12) and,
  through ``all_matches_arrays``, config 5's 1,000 needles on the corpus
  that holds every one (each comb32 group's B15 and B17, the comb16 group's
  B8 and B12), each equal to the bitmap route's (or the host's) answer; and a 30-needle engine with ``t_tile=48`` (count
  and matches, B1 and B5);
* the reference scan engine (``XlaAcEngine``, no kernel) that the
  dispatcher takes for an empty needle beside config 5's first 1,000, at
  4 MiB: ``count_matches``, ``contains_any``, ``contains_all`` and
  ``all_matches_arrays`` equal to the host C++ engine's, and to the python
  oracle's on the first 64 KiB;
* IgnoreCase: the bench needles over the bench corpus with its letters
  uppercased at random (128 MiB), on the composed case DFA's byte-class
  bitap with a trap embedded in its word (B2, B4, B7 with their trap parts;
  B6's dense step for extraction), with ``AMT_BITAP=0`` (B1, B3 and B6 on
  the composed machine) as the control; the same corpus with ``TSHİRT``
  written into 100 streams (the trapped streams re-counted on the host) and
  into 1,000 (the dense fallback, B1); config 2's 100 needles on the
  composed machine's comb16 tables (B8, B10, B13); and the lowering path:
  config 5's first 600 needles, whose composed machine no single-pass
  engine holds, lowered on the host (32 MiB) and scanned by the grouped
  engine.  Answers against the host C++ engine on the composed machine (or,
  on the lowering path, on the lowered bytes with the ends mapped back), and
  the python IgnoreCase oracle on 64 KiB with the case probes (İ, Ⱥ, Kelvin
  K, Å, ẞ).

Every answer must equal the host C++ engine's (and the control's), and every
kernel of a path must have been launched by it.  Last it times every kernel
(the trap parts on the IgnoreCase bench staging, with an embedded trap and
with a trap register) and its plain version with CUDA events, B8 against B1 on one 30-needle
set that both engines hold, and B9 against the per-group B15 and B8 passes
it replaces, beside the host C++ engine's count.  Any failure raises and the exit code is
non-zero.  Without a CUDA device it exits non-zero before printing a result.

The last three lines of standard output are the kernels' JSON summary, the
card's ``nvidia-smi`` name and power limit, and ``{"ok": true, "device":
{...}}``.
"""

import dataclasses
import json
import os
import sys
import time
from unittest import mock

import numpy as np

#: The benchmark's configuration (``bench.py``): needles, corpus, seed.
NEEDLES = ["tshirt", "shirts", "shorts"]
#: Needles with bytes the lower-case corpus never holds: no match anywhere.
MISS_NEEDLES = ["Tshirt9", "SHORTS"]
CORPUS_BYTES = 128 << 20
CHECK_BYTES = 4 << 20  # corpus of the per-kernel checks
REFERENCE_BYTES = 4 << 20  # corpus of the reference scan engine
LOWERING_BYTES = 32 << 20  # corpus of the IgnoreCase lowering path
ORACLE_BYTES = 64 << 10  # the part of it the python oracle scans
KERNEL_RUNS = 20
PLAIN_RUNS = 2
#: The corpus of ``alfred_margaret_tpu/bench/configs.py`` config 2b.
DIGITS = b"0123456789 ,;:!"
#: H100 SXM data sheet: HBM3 bandwidth, and the float32 rate outside the
#: tensor cores, taken as the card's rate for 32-bit integer work.
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def random_needles(seed: int, n: int):
    """``n`` distinct random lower-case needles of 4 to 8 letters, drawn as
    ``alfred_margaret_tpu/bench/configs.py`` draws config 2's."""
    rng = np.random.default_rng(seed)
    return list(dict.fromkeys(
        "".join(chr(97 + c) for c in rng.integers(0, 26, size=rng.integers(4, 9)))
        for _ in range(int(n * 1.1))
    ))[:n]


def config2_needles():
    """``BASELINE.json`` config 2: 100 needles, four of them nested."""
    needles = random_needles(7, 100)
    needles[:4] = ["abc", "abcd", "bcd", "c"]
    return needles


def config5_needles(n: int):
    """The first ``n`` needles of ``BASELINE.json`` config 5, drawn as
    ``alfred_margaret_tpu/bench/configs.py`` draws them: config 2's 110
    draws from ``default_rng(7)``, then 11,000 needles of 5 to 11 letters,
    the first 10,000 distinct ones kept."""
    rng = np.random.default_rng(7)
    list("".join(chr(97 + c) for c in rng.integers(0, 26, size=rng.integers(4, 9)))
         for _ in range(110))
    return list(dict.fromkeys(
        "".join(chr(97 + c) for c in rng.integers(0, 26, size=rng.integers(5, 12)))
        for _ in range(11000)
    ))[:n]


def fire_free(n: int, seed: int = 0) -> bytes:
    """``n`` random bytes over ``b"0 "``: no chain of config 2's screen fires."""
    rng = np.random.default_rng(seed)
    return rng.choice(np.frombuffer(b"0 ", np.uint8), n).astype(np.uint8).tobytes()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; needs one CUDA card",
              file=sys.stderr)
        return 1

    from alfred_margaret_tpu_torch import (
        CASE_SENSITIVE, IGNORE_CASE, MatchEngine, Searcher, toolchain_report)
    from alfred_margaret_tpu_torch import kernels as K
    from alfred_margaret_tpu_torch.bench.dataformat import synth_corpus
    from alfred_margaret_tpu_torch.kernels import build
    from alfred_margaret_tpu_torch.models import ac, case_dfa
    from alfred_margaret_tpu_torch.native import build as native_build
    from alfred_margaret_tpu_torch.native.cpp_engine import CppAcEngine
    from alfred_margaret_tpu_torch.ops.bitap_scan import BitapAcEngine, plan_bitap, plan_bitap_ci
    from alfred_margaret_tpu_torch.ops.comb16_scan import Comb16AcEngine
    from alfred_margaret_tpu_torch.ops.comb_scan import CombAcEngine
    from alfred_margaret_tpu_torch.ops.grouped import GroupedAcEngine
    from alfred_margaret_tpu_torch.ops.pallas_scan import DenseAcEngine, _zero_inert
    from alfred_margaret_tpu_torch.ops.xla_scan import XlaAcEngine
    from alfred_margaret_tpu_torch.utils import utf8
    from alfred_margaret_tpu_torch.utils.device import nvidia_smi_line

    dev = torch.device("cuda", 0)
    gpu = torch.cuda.get_device_name(0)
    check("H100" in gpu, f"expected an H100, found {gpu!r}")
    card = nvidia_smi_line()
    print("toolchain", json.dumps(toolchain_report()), flush=True)

    # -- build ---------------------------------------------------------------
    t0 = time.perf_counter()
    built = build.load()
    print(f"build: {time.perf_counter() - t0:.1f} s ({built.seconds:.1f} s in nvcc) -> {built.path}")
    for line in built.log.splitlines():  # nvcc -Xptxas=-v: registers and spills
        if line.startswith("== ") or "Compiling entry" in line or "Used" in line or (
            "spill" in line and " 0 bytes spill stores" not in line
        ):
            print("  ptxas:", line.split(":", 1)[-1].strip() if "ptxas" in line else line)
    native_build.load()  # the host C++ engine every answer is held against

    # B13 is B6's wrapper with the comb16 step, and the trap parts of B2, B4
    # and B7 are their wrappers given a trap mask: their errors and launches
    # are kept apart.
    TRAP_WRAPPERS = (K.bitap_count, K.bitap_contains, K.bitap_presence)
    max_err = {**{w.__name__: 0 for w in K.WRAPPERS}, "matchbits_comb16": 0,
               **{w.__name__ + "_trap": 0 for w in TRAP_WRAPPERS}}

    def same(name, k, p, label):
        """Kernel output ``k`` equals plain output ``p`` exactly, on every
        stream (the kernels mask or hold fully padded streams as their plain
        versions do); records the max abs error."""
        torch.cuda.synchronize()
        check(k.shape == p.shape, f"{name} {label}: shape {tuple(k.shape)} != {tuple(p.shape)}")
        err = int((k.long() - p.long()).abs().max()) if k.numel() else 0
        max_err[name] = max(max_err[name], err)
        check(err == 0, f"{name} {label}: kernel != plain (max err {err})")

    def compare(name, eng, st, label):
        """B1/B2/B8 vs plain on the same staged streams.  Returns the
        kernel's total over live streams."""
        k = eng.stream_counts(st)
        same(name, k, eng.stream_counts_plain(st), label)
        return int(k[torch.from_numpy(st.live_np).to(dev)].long().sum())

    def check_sticky_and_bits(eng, st, label):
        """B3 (dense), B4 + B7 (bitap) or B10 + B14 (comb16), and B6 or B13;
        or B16 (comb32); against their plain versions on the same staged
        streams."""
        if isinstance(eng, CombAcEngine):
            args = eng.sticky_args(st)
            same("comb_contains", K.comb_contains(*args), K.comb_contains_plain(*args), label)
            return "comb32 states"
        if isinstance(eng, BitapAcEngine):
            args = eng.sticky_bitap_args(st)
            same("bitap_contains", K.bitap_contains(*args), K.bitap_contains_plain(*args), label)
            same("bitap_presence", K.bitap_presence(*args), K.bitap_presence_plain(*args), label)
        elif isinstance(eng, Comb16AcEngine):
            args = eng.sticky_args(st)
            same("comb16_contains", K.comb16_contains(*args), K.comb16_contains_plain(*args), label)
            if eng._filter_tables is not None:
                args = (st.streams, st.vend, *eng._filter_tables.args())
                same("filter_contains", K.filter_contains(*args), K.filter_contains_plain(*args),
                     label)
        else:
            args = eng.sticky_args(st)
            whole = K.dense_contains(*args)
            same("dense_contains", whole, K.dense_contains_plain(*args), label)
            S = st.plan.n_streams
            parts = [K.dense_contains(*eng.sticky_args(st, k * S // 4, (k + 1) * S // 4))
                     for k in range(4)]
            same("dense_contains", torch.cat(parts), whole, label + ", K=4 segments")
        args = eng.bits_args(st)
        name = "matchbits_comb16" if args[3] == "comb16" else "matchbits"
        counts, bits = K.matchbits(*args)
        pcounts, pbits = K.matchbits_plain(*args)
        same(name, counts, pcounts, label + " counts")
        same(name, bits, pbits, label + " bitmap")
        return args[3]

    def states_kernel(eng):
        """(name, kernel, plain) of ``eng``'s packed-states kernel."""
        if isinstance(eng, CombAcEngine):
            return "comb_states", K.comb_states, K.comb_states_plain
        if isinstance(eng, Comb16AcEngine):
            return "comb16_states", K.comb16_states, K.comb16_states_plain
        return "dense_states", K.dense_states, K.dense_states_plain

    def check_states(eng, st, m, data, label):
        """B5, B12 or B17 against its plain version; ``final_states`` against
        the host C++ engine's; and the extraction without the host corpus
        against the one with it (the bitmap route, but on comb32)."""
        name, kernel, plain = states_kernel(eng)
        args = eng.states_args(st)
        same(name, kernel(*args), plain(*args), label)
        check(np.array_equal(eng.final_states_staged(st), CppAcEngine(m).final_states(data)),
              f"{label}: final_states != host C++")
        bare = eng.match_positions_staged(dataclasses.replace(st, data_np=None))
        check(all(np.array_equal(a, b) for a, b in zip(bare, eng.match_positions_staged(st))),
              f"{label}: extraction without the host corpus != with it")
        return name

    def check_answers(eng, st, m, data, label):
        """The engine's answers against the host C++ engine's."""
        host = CppAcEngine(m)
        any_ = eng.contains_staged(st)
        check(any_ == (host.first_hit(data) >= 0), f"{label}: contains != host C++")
        if isinstance(eng, BitapAcEngine):
            pres = eng.needle_presence_staged(st)
        else:
            if not isinstance(eng, Comb16AcEngine):
                check(eng.contains_staged_early(st, n_segments=4) == any_,
                      f"{label}: early != whole")
            _, hit = eng.match_positions_staged(st)
            pres = ac.presence_of_states(m, hit, len(m.values))
        check(np.array_equal(pres, host.value_presence(data, len(m.values))),
              f"{label}: presence != host C++")
        ends, vids = eng.matches_arrays_staged(st)
        hends, hvids = host.matches_arrays(data)
        check(np.array_equal(ends, hends) and np.array_equal(vids, hvids),
              f"{label}: matches ({len(ends)}) != host C++ ({len(hends)})")
        return any_, int(pres.sum()), len(ends)

    # -- kernels against their plain versions --------------------------------
    def machine_of(needles):
        return ac.build([(n, i) for i, n in enumerate(needles)])

    v2 = ["alpha", "bravo", "charlie", "delta", "echo", "foxtrot", "golf"]
    pk2 = [bytes([97 + i % 11, 98 + (i * 3) % 9, 99 + i % 7]).decode() for i in range(30)]
    c2 = config2_needles()
    n97 = [n for n in c2 if len(n) >= 4]
    cases = [
        ("bitap_count", "bench needles", NEEDLES),
        ("bitap_count", "overlap and suffix needles", ["ab", "b", "abc", "zz"]),
        ("bitap_count", "duplicate needles", ["x", "x", "yy", "x"]),
        ("bitap_count", "two words (V=2)", v2),
        ("dense_count", "bench needles, AMT_BITAP=0", NEEDLES),
        ("dense_count", "30 needles, packing 2", pk2),
        ("dense_count", "NUL needles, not zero-inert", ["a\x00b", "\x00\x00", "xyz"]),
        ("dense_count", "30 random needles", random_needles(30, 30)),
        ("comb16_count", "config 2, 100 needles", c2),
        ("comb16_count", "nested, 4 count ranges", ["a", "aa", "aaa", "aaaa", "aaaaa"]
         + random_needles(13, 80)),
        ("comb16_count", "150 needles", random_needles(21, 150)),
        ("comb16_count", "97 needles, no short one", n97),
        ("comb16_count", "NUL needles, no screen", c2[:60] + ["a\x00b", "\x00\x00x"]),
        ("comb_count", "200 needles", random_needles(22, 200)),
        ("comb_count", "config 5, 300 needles", config5_needles(300)),
        ("comb_count", "nested, counts of 5", ["a", "aa", "aaa", "aaaa", "aaaaa"]
         + random_needles(31, 120)),
        ("comb_count", "NUL needles", random_needles(22, 200)[:150] + ["a\x00b", "\x00\x00x"]),
    ]
    for seed, (name, label, needles) in enumerate(cases):
        m = machine_of(needles)
        data = np.frombuffer(
            synth_corpus(needles, CHECK_BYTES, hit_fraction=0.02, seed=seed), np.uint8
        )
        if name == "bitap_count":
            eng = BitapAcEngine(m, layout=plan_bitap(m, max_words=2), device=dev)
            extra = f"V={eng.bitap.n_words}"
        elif name == "dense_count":
            eng = DenseAcEngine(m, device=dev)
            extra = f"packing={eng.comp.packing} zero_inert={_zero_inert(m)}"
        elif name == "comb_count":
            eng = CombAcEngine(m, device=dev)
            extra = (f"rows={eng.comb.rows_c}+{eng.comb.rows_d} D={eng.comb.D} "
                     f"max_count={int(m.match_count.max())}")
        else:
            eng = Comb16AcEngine(m, device=dev)
            lay = eng._filter_lay
            extra = (f"ranges={len(eng.c16.count_ranges)} screen="
                     + (f"{lay.n_words}w{len(lay.shorts)}s" if lay else "none"))
        if label.startswith("two words"):
            check(eng.bitap.n_words == 2, "V=2 case planned to another width")
        if "packing 2" in label:
            check(eng.comp.packing == 2, "packing-2 case planned to packing 1")
        if "NUL" in label:
            check(not _zero_inert(m), "NUL case is zero-inert")
        if label.startswith("nested") and name == "comb16_count":
            check(len(eng.c16.count_ranges) == 4, "nested case has no 4 count ranges")
        if name == "comb_count" and label in ("200 needles", "config 5, 300 needles"):
            check(type(Searcher.build(CASE_SENSITIVE, needles)._engine.device_engine())
                  is CombAcEngine, f"{label}: the dispatcher does not take comb32")
        if name == "comb16_count":
            check(("NUL" in label) == (eng._filter_tables is None), f"{label}: screen planned wrong")
        st = eng.stage(data)
        total = compare(name, eng, st, label)
        ref = CppAcEngine(m).count(data)
        check(total == ref, f"{name} {label}: kernel {total} != host C++ {ref}")
        step = check_sticky_and_bits(eng, st, label)
        states = check_states(eng, st, m, data, label)
        any_, n_present, n_matches = check_answers(eng, st, m, data, label)
        print(f"check {name:12s} {label:30s} {extra:30s} count={total} host_cpp={ref} "
              f"contains={any_} present={n_present}/{len(m.values)} matches={n_matches} "
              f"bits_step={step} states={states} ok")

    def check_grouped(eng, st, data, label):
        """B9, B11 and B14 against their plain versions on the same staged
        streams, and the grouped engine's answers against the host C++
        engine's."""
        m = eng.machine
        same("comb16_count_grouped", eng.stream_counts(st), eng.stream_counts_plain(st), label)
        args = eng.sticky_args(st)
        same("comb16_contains_grouped", K.comb16_contains_grouped(*args),
             K.comb16_contains_grouped_plain(*args), label)
        if eng._filter_tables is not None:
            args = (st.streams, st.vend, *eng._filter_tables.args())
            same("filter_contains", K.filter_contains(*args), K.filter_contains_plain(*args),
                 label)
        host = CppAcEngine(m)
        total = eng.count_staged(st)
        check(total == host.count(data), f"{label}: count {total} != host C++")
        any_ = eng.contains_staged(st)
        check(any_ == (host.first_hit(data) >= 0), f"{label}: contains != host C++")
        pres = eng.value_presence_staged(st, len(m.values))
        check(np.array_equal(pres, host.value_presence(data, len(m.values))),
              f"{label}: presence != host C++")
        ends, vids = eng.matches_arrays_staged(st)
        hends, hvids = host.matches_arrays(data)
        check(np.array_equal(ends, hends) and np.array_equal(vids, hvids),
              f"{label}: matches ({len(ends)}) != host C++ ({len(hends)})")
        # Without the host corpus every group extracts through its packed
        # states; the comb16 groups' B12 against its plain version.
        bare = dataclasses.replace(st, data_np=None)
        bends, bvids = eng.matches_arrays_staged(bare)
        check(np.array_equal(bends, hends) and np.array_equal(bvids, hvids),
              f"{label}: matches without the host corpus != host C++")
        check(np.array_equal(eng.value_presence_staged(bare, len(m.values)), pres),
              f"{label}: presence without the host corpus != with it")
        for g, e in enumerate(eng.engines):
            if type(e) is Comb16AcEngine:
                check_states(e, st, e.machine, data, f"{label}, comb16 group {g}")
        return total, any_, int(pres.sum()), len(ends)

    # The grouped engine on config 5's first 1,000 needles (the main path's
    # engine, built here once) and on a NUL-bearing set that is not
    # zero-inert.
    n1000 = config5_needles(1000)
    t0 = time.perf_counter()
    s1000 = Searcher.build(CASE_SENSITIVE, n1000)
    eng5 = s1000._engine.device_engine()
    groups_s = time.perf_counter() - t0
    fused5, sticky5 = eng5._fused_setup(), eng5._fused_sticky_setup()
    build5_s = time.perf_counter() - t0
    check(type(eng5) is GroupedAcEngine, f"1,000 needles took {type(eng5).__name__}")
    check(fused5 is not None and sticky5 is not None, "1,000 needles: a fused setup is off")
    lay5 = eng5._filter_lay
    check(lay5 is not None and lay5.n_words == 12, "1,000 needles: not a 12-word screen")
    kinds = {}
    for e in eng5.engines:
        kinds[type(e).__name__] = kinds.get(type(e).__name__, 0) + 1
    f5, y5 = fused5.tables, sticky5.tables
    print(f"grouped build: {len(n1000)} needles, {s1000.automaton.n_states} states -> "
          f"{eng5.n_groups} groups {kinds} (summed rows {eng5.total_rows}) in {groups_s:.1f} s; "
          f"fused count G={f5.n_groups} rows {f5.comb.shape[1] // 128}+{f5.aux.shape[1] // 128}"
          f"+2 BB={f5.BB} and sticky G={y5.n_groups} rows {y5.comb.shape[1] // 128}+"
          f"{y5.aux.shape[1] // 128}+2 BB={y5.BB} in {build5_s - groups_s:.1f} s; screen "
          f"{lay5.n_words} words {len(lay5.shorts)} shorts; {build5_s:.1f} s host in all",
          flush=True)
    nul_needles = n1000[:300] + ["a\x00b", "\x00\x00x"]
    eng_nul = GroupedAcEngine(machine_of(nul_needles), device=dev)
    check(eng_nul._fused_setup() is not None and eng_nul._fused_sticky_setup() is not None
          and not _zero_inert(eng_nul.machine), "NUL grouped set: fused setups or NUL")
    for seed, (label, eng, needles) in enumerate((
            ("1,000 needles of config 5", eng5, n1000), ("300 + NUL needles", eng_nul, nul_needles))):
        data = np.frombuffer(
            synth_corpus(needles, CHECK_BYTES, hit_fraction=0.02, seed=20 + seed), np.uint8)
        total, any_, n_present, n_matches = check_grouped(eng, eng.stage(data), data, label)
        print(f"check grouped      {label:30s} groups={eng.n_groups} fused G="
              f"{eng._fused.tables.n_groups}/{eng._fused_sticky.tables.n_groups} count={total} "
              f"contains={any_} present={n_present}/{len(eng.machine.values)} "
              f"matches={n_matches} ok")

    def zero_counts():
        for w in K.WRAPPERS:
            w.launches = 0
        for w in TRAP_WRAPPERS:
            w.launches_trap = 0
        for step in K.matchbits.launches_by_step:
            K.matchbits.launches_by_step[step] = 0

    def read_counts():
        """Each wrapper's launches; B6's with the comb16 step count as B13's
        (``matchbits_comb16``), and B2's, B4's and B7's with a trap mask as
        their trap parts' (``bitap_count_trap``, ...), as the wrappers count
        them apart."""
        counts = {w.__name__: w.launches for w in K.WRAPPERS}
        counts["matchbits_comb16"] = K.matchbits.launches_by_step["comb16"]
        counts["matchbits"] -= counts["matchbits_comb16"]
        for w in TRAP_WRAPPERS:
            counts[w.__name__ + "_trap"] = w.launches_trap
            counts[w.__name__] -= w.launches_trap
        return counts

    def tally(into, used):
        for k, v in used.items():
            if v:
                into[k] = into.get(k, 0) + v
        return into

    def run_ops(ops, want):
        """Run each ``(operation, who, call)``, check its answer against
        ``want`` and print its wall time and the kernels it launched."""
        for op, who, call in ops:
            before = read_counts()
            t0 = time.perf_counter()
            out = call()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            after = read_counts()
            used = {k: after[k] - before[k] for k in after if after[k] != before[k]}
            if isinstance(out, tuple):  # all_matches_arrays
                ends, vids = out
                hends, hvids = want[op]
                check(np.array_equal(ends, hends) and np.array_equal(vids, hvids),
                      f"{op} ({who}): {len(ends)} matches != host C++ {len(hends)}")
                shown = f"{len(ends)} matches"
            else:
                check(out == want[op], f"{op} ({who}): {out} != host C++ {want[op]}")
                shown = str(out)
            print(f"op {op:28s} {who:16s} {wall * 1e3:10.3f} ms wall  -> {shown:16s} "
                  f"launches {used} ({card})", flush=True)
            yield op, who, used

    # -- the count path at the benchmark's size -----------------------------
    data = np.frombuffer(
        synth_corpus(NEEDLES, CORPUS_BYTES, hit_fraction=0.01, seed=3), np.uint8
    )
    host = CppAcEngine(machine_of(NEEDLES))
    searcher = Searcher.build(CASE_SENSITIVE, NEEDLES)  # the default device: the card
    check(searcher.device == dev, f"Searcher defaulted to {searcher.device}")
    with mock.patch.dict(os.environ, {"AMT_BITAP": "0"}):  # dense controls
        dense_searcher = Searcher(
            CASE_SENSITIVE, searcher.needles, machine=searcher.automaton, device="cuda"
        )
        dense_eng = dense_searcher._engine.device_engine()
    bitap_eng = searcher._engine.device_engine()
    check(isinstance(bitap_eng, BitapAcEngine), f"main path took {type(bitap_eng).__name__}")
    check(type(dense_eng) is DenseAcEngine, f"control took {type(dense_eng).__name__}")

    # Launches of each path's main-path operations, and of its controls.
    bench_main, bench_control = {}, {}
    zero_counts()
    t0 = time.perf_counter()
    staged = searcher.stage(data)
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = searcher.count_matches(staged)
    count_s = time.perf_counter() - t0
    tally(bench_main, read_counts())
    zero_counts()
    got_dense = dense_searcher.count_matches(staged)
    tally(bench_control, read_counts())
    check(bench_main.get("bitap_count", 0) > 0, "bitap_count was not launched by the count path")
    check(bench_control.get("dense_count", 0) > 0, "dense_count was not launched by the control")
    st = staged.device
    print(f"count path: {CORPUS_BYTES} bytes, {st.plan}, stage {stage_s:.3f} s, "
          f"count_matches {count_s:.3f} s, launches {bench_main}, control {bench_control}")
    ref = host.count(data)
    check(got == ref, f"main path count {got} != host C++ engine {ref}")
    check(got_dense == got, f"dense control {got_dense} != bitap {got}")
    check(got > 0, "main path counted no match")
    print(f"count path: count {got} == host C++ engine {ref} == dense control {got_dense}")

    # -- containsAny, containsAll and allMatches at the benchmark's size -----
    miss = Searcher.build(CASE_SENSITIVE, MISS_NEEDLES)
    absent = Searcher.build(CASE_SENSITIVE, NEEDLES + ["SHORTS"])
    with mock.patch.dict(os.environ, {"AMT_BITAP": "0"}):  # dense controls
        miss_dense = Searcher(CASE_SENSITIVE, miss.needles, machine=miss.automaton, device="cuda")
        absent_dense = Searcher(CASE_SENSITIVE, absent.needles, machine=absent.automaton,
                                device="cuda")
        for s in (miss_dense, absent_dense):
            check(type(s._engine.device_engine()) is DenseAcEngine, "control is not dense")
    staged_miss = miss.stage(data)
    staged_absent = absent.stage(data)
    torch.cuda.synchronize()
    want = {
        "contains_any hit": host.first_hit(data) >= 0,
        "contains_any miss": CppAcEngine(miss.automaton).first_hit(data) >= 0,
        "contains_all true": bool(host.value_presence(data, len(NEEDLES)).all()),
        "contains_all false": bool(
            CppAcEngine(absent.automaton).value_presence(data, len(NEEDLES) + 1).all()),
    }
    check(want == {"contains_any hit": True, "contains_any miss": False,
                   "contains_all true": True, "contains_all false": False},
          f"host C++ answers are not the expected ones: {want}")
    want["all_matches_arrays"] = host.matches_arrays(data)
    check(len(want["all_matches_arrays"][0]) == got, "host C++ matches != count")
    ops = [
        ("contains_any hit", "main path", lambda: searcher.contains_any(staged)),
        ("contains_any hit", "dense control", lambda: dense_searcher.contains_any(staged)),
        ("contains_any miss", "main path", lambda: miss.contains_any(staged_miss)),
        ("contains_any miss", "dense control", lambda: miss_dense.contains_any(staged_miss)),
        ("contains_all true", "main path", lambda: searcher.contains_all(staged)),
        ("contains_all true", "dense control", lambda: dense_searcher.contains_all(staged)),
        ("contains_all false", "main path", lambda: absent.contains_all(staged_absent)),
        ("contains_all false", "dense control", lambda: absent_dense.contains_all(staged_absent)),
        ("all_matches_arrays", "main path", lambda: searcher.all_matches_arrays(staged)),
        ("all_matches_arrays", "dense control", lambda: dense_searcher.all_matches_arrays(staged)),
    ]
    op_main, op_control = {}, {}
    zero_counts()
    for op, who, used in run_ops(ops, want):
        if op == "contains_any hit" and who == "dense control":
            check(used.get("dense_contains") == 4, f"dense contains_any ran {used} (not 4 segments)")
        tally(op_main if who == "main path" else op_control, used)
    for name in ("bitap_contains", "matchbits", "bitap_presence"):
        check(op_main.get(name, 0) > 0, f"{name} was not launched by the operations' main path")
    check(op_control.get("dense_contains", 0) > 0, "dense_contains was not launched by the control")
    tally(bench_main, op_main)
    tally(bench_control, op_control)
    print(f"operations' main path: every answer == host C++ == dense control; "
          f"launches {op_main}, control {op_control}")

    # -- the comb16 path: config 2's 100 needles at 128 MiB -------------------
    t0 = time.perf_counter()
    data2 = np.frombuffer(synth_corpus(c2, CORPUS_BYTES, hit_fraction=0.01, seed=5), np.uint8)
    digits = (DIGITS * (CORPUS_BYTES // len(DIGITS) + 1))[:CORPUS_BYTES]
    half = CORPUS_BYTES // 2
    digits_hit = digits[:half] + c2[7].encode() + digits[half:]
    clean = fire_free(CORPUS_BYTES, seed=1)
    corpora = {"config 2": data2, "fire-free": clean, "digits (2b)": digits,
               "digits + 1 needle": digits_hit}
    s100 = Searcher.build(CASE_SENSITIVE, c2)
    absent100 = Searcher.build(CASE_SENSITIVE, c2 + ["SHORTS"])
    with mock.patch.dict(os.environ, {"AMT_FILTER": "0"}):  # the control: no screen
        nofilter = Searcher(CASE_SENSITIVE, s100.needles, machine=s100.automaton)
        check(nofilter._engine.device_engine()._filter_tables is None, "control has a screen")
    eng2 = s100._engine.device_engine()
    for s in (s100, absent100):
        check(type(s._engine.device_engine()) is Comb16AcEngine,
              f"config 2 took {type(s._engine.device_engine()).__name__}")
    lay = eng2._filter_lay
    check(lay is not None and (lay.n_words, len(lay.shorts)) == (3, 3), "config 2's screen plan")
    host2 = CppAcEngine(s100.automaton)
    want2 = {f"contains_any {k}": host2.first_hit(v) >= 0 for k, v in corpora.items()}
    want2["contains_all true"] = bool(host2.value_presence(data2, len(c2)).all())
    want2["contains_all false"] = bool(
        CppAcEngine(absent100.automaton).value_presence(data2, len(c2) + 1).all())
    want2["all_matches_arrays"] = host2.matches_arrays(data2)
    count2_ref = host2.count(data2)
    check([want2[f"contains_any {k}"] for k in corpora] == [True, False, False, True]
          and want2["contains_all true"] and not want2["contains_all false"],
          f"host C++ answers are not the expected ones: {want2}")
    print(f"comb16 path: corpora and host C++ answers in {time.perf_counter() - t0:.1f} s; "
          f"engine states={eng2.c16.n_states} (full {eng2.c16_full.n_states}) k={eng2.c16.k} "
          f"rows_c={eng2.c16.rows_c} rows_a={eng2.c16.rows_a} "
          f"count_ranges={eng2.c16.count_ranges} screen={lay.n_words} words "
          f"{len(lay.shorts)} shorts", flush=True)

    zero_counts()
    t0 = time.perf_counter()
    st2 = {k: s100.stage(v) for k, v in corpora.items()}
    torch.cuda.synchronize()
    stage2_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got2 = s100.count_matches(st2["config 2"])
    count2_s = time.perf_counter() - t0
    c16_main, c16_control = tally({}, read_counts()), {}
    check(got2 == count2_ref > 0, f"comb16 count {got2} != host C++ {count2_ref}")
    print(f"comb16 path: stage 4 x {CORPUS_BYTES} bytes {stage2_s:.3f} s, count_matches "
          f"{count2_s * 1e3:.3f} ms -> {got2} == host C++ {count2_ref}")
    staged_absent2 = absent100.stage(data2)
    ops2 = [(f"contains_any {k}", "main path", (lambda v=v: s100.contains_any(v)))
            for k, v in st2.items()]
    ops2 += [(f"contains_any {k}", "AMT_FILTER=0", (lambda v=v: nofilter.contains_any(v)))
             for k, v in st2.items()]
    ops2 += [
        ("contains_all true", "main path", lambda: s100.contains_all(st2["config 2"])),
        ("contains_all false", "main path", lambda: absent100.contains_all(staged_absent2)),
        ("all_matches_arrays", "main path", lambda: s100.all_matches_arrays(st2["config 2"])),
    ]
    # The kernels each main-path operation must launch, and no other.
    expect = {
        "contains_any config 2": {"filter_contains"},  # a short needle: the screen says True
        "contains_any fire-free": {"filter_contains"},  # no fire: the screen says False
        "contains_any digits (2b)": {"filter_contains", "comb16_contains"},  # candidates
        "contains_any digits + 1 needle": {"filter_contains", "comb16_contains"},
        "contains_all true": {"matchbits_comb16"},
        "contains_all false": {"matchbits_comb16"},
        "all_matches_arrays": {"matchbits_comb16"},
    }
    for op, who, used in run_ops(ops2, want2):
        if who == "main path":
            check(set(used) == expect[op], f"{op}: launched {used}, expected {expect[op]}")
            tally(c16_main, used)
        else:
            check(set(used) == {"comb16_contains"}, f"{op} ({who}): launched {used}")
            tally(c16_control, used)
    for name in ("comb16_count", "comb16_contains", "matchbits_comb16", "filter_contains"):
        check(c16_main.get(name, 0) > 0, f"{name} was not launched by the comb16 path")
    print(f"comb16 path: every answer == host C++ == AMT_FILTER=0 control; "
          f"launches {c16_main}, control {c16_control}")

    # -- the dense path: 30 needles at 128 MiB ---------------------------------
    n30 = random_needles(30, 30)
    data30 = np.frombuffer(synth_corpus(n30, CORPUS_BYTES, hit_fraction=0.01, seed=9), np.uint8)
    s30 = Searcher.build(CASE_SENSITIVE, n30)
    dense30 = s30._engine.device_engine()
    check(type(dense30) is DenseAcEngine, f"30 needles took {type(dense30).__name__}")
    m30 = s30.automaton
    host30 = CppAcEngine(m30)
    want30 = {"count_matches": host30.count(data30),
              "contains_any": host30.first_hit(data30) >= 0,
              "contains_all": bool(host30.value_presence(data30, len(n30)).all()),
              "all_matches_arrays": host30.matches_arrays(data30)}
    check(want30["count_matches"] > 0 and want30["contains_any"] and want30["contains_all"],
          "host C++ answers are not the expected ones for 30 needles")
    zero_counts()
    staged30 = s30.stage(data30)
    ops30 = [
        ("count_matches", "main path", lambda: s30.count_matches(staged30)),
        ("contains_any", "main path", lambda: s30.contains_any(staged30)),
        ("contains_all", "main path", lambda: s30.contains_all(staged30)),
        ("all_matches_arrays", "main path", lambda: s30.all_matches_arrays(staged30)),
    ]
    expect30 = {"count_matches": {"dense_count"}, "contains_any": {"dense_contains"},
                "contains_all": {"matchbits"}, "all_matches_arrays": {"matchbits"}}
    dense_main = {}
    for op, who, used in run_ops(ops30, want30):
        check(set(used) == expect30[op], f"{op}: launched {used}, expected {expect30[op]}")
        tally(dense_main, used)
    print(f"dense path: every answer == host C++; launches {dense_main}")

    # -- the comb32 path: config 5's first 300 needles at 128 MiB -------------
    t0 = time.perf_counter()
    n300 = config5_needles(300)
    s300 = Searcher.build(CASE_SENSITIVE, n300)
    absent300 = Searcher.build(CASE_SENSITIVE, n300 + ["SHORTS"])
    eng3 = s300._engine.device_engine()
    for s in (s300, absent300):
        check(type(s._engine.device_engine()) is CombAcEngine,
              f"config 5's 300 needles took {type(s._engine.device_engine()).__name__}")
    data3 = np.frombuffer(synth_corpus(n300, CORPUS_BYTES, hit_fraction=0.01, seed=13), np.uint8)
    tail3 = np.frombuffer(" ".join(n300).encode(), np.uint8)  # every needle: containsAll true
    data3_all = np.concatenate([data3[: CORPUS_BYTES - len(tail3)], tail3])
    corpora3 = {"config 5, 300": data3, "digits (2b)": digits,
                "digits + 1 needle": digits[:half] + n300[-1].encode() + digits[half:]}
    host3 = CppAcEngine(s300.automaton)
    want3 = {f"contains_any {k}": host3.first_hit(v) >= 0 for k, v in corpora3.items()}
    want3["count_matches"] = host3.count(data3)
    want3["contains_all true"] = bool(host3.value_presence(data3_all, len(n300)).all())
    want3["contains_all false"] = bool(
        CppAcEngine(absent300.automaton).value_presence(data3, len(n300) + 1).all())
    want3["all_matches_arrays"] = host3.matches_arrays(data3)
    check([want3[f"contains_any {k}"] for k in corpora3] == [True, False, True]
          and want3["contains_all true"] and not want3["contains_all false"]
          and want3["count_matches"] > 0, f"host C++ answers are not the expected ones: {want3}")
    print(f"comb32 path: engine and host C++ answers in {time.perf_counter() - t0:.1f} s; "
          f"states={eng3.comb.n_states} (full {eng3.comb_full.n_states}) k={eng3.comb.k} "
          f"rows={eng3.comb.rows_c}+{eng3.comb.rows_d} (full {eng3.comb_full.rows_c}+"
          f"{eng3.comb_full.rows_d}) D={eng3.comb.D}", flush=True)
    zero_counts()
    t0 = time.perf_counter()
    st3 = {k: s300.stage(v) for k, v in corpora3.items()}
    staged3_all = s300.stage(data3_all)
    staged_absent3 = absent300.stage(data3)
    torch.cuda.synchronize()
    stage3_s = time.perf_counter() - t0
    ops3 = [("count_matches", "main path", lambda: s300.count_matches(st3["config 5, 300"]))]
    ops3 += [(f"contains_any {k}", "main path", (lambda v=v: s300.contains_any(v)))
             for k, v in st3.items()]
    ops3 += [
        ("contains_all true", "main path", lambda: s300.contains_all(staged3_all)),
        ("contains_all false", "main path", lambda: absent300.contains_all(staged_absent3)),
        ("all_matches_arrays", "main path", lambda: s300.all_matches_arrays(st3["config 5, 300"])),
    ]
    # The kernels each operation must launch, and no other: B15 then B17 for
    # the extraction.
    extract32 = {"comb_count": 1, "comb_states": 1}
    expect3 = {"count_matches": {"comb_count": 1}, "contains_all true": extract32,
               "contains_all false": extract32, "all_matches_arrays": extract32,
               **{f"contains_any {k}": {"comb_contains": 1} for k in corpora3}}
    c32_main = {}
    for op, who, used in run_ops(ops3, want3):
        check(used == expect3[op], f"{op}: launched {used}, expected {expect3[op]}")
        tally(c32_main, used)
    print(f"comb32 path: stage 5 x {CORPUS_BYTES} bytes {stage3_s:.3f} s; every answer == "
          f"host C++; launches {c32_main}")

    # -- the grouped path: config 5's first 1,000 needles at 128 MiB ----------
    t0 = time.perf_counter()
    data5 = np.frombuffer(
        synth_corpus(n1000[:500], CORPUS_BYTES, hit_fraction=0.01, seed=11), np.uint8)
    # The config-5 corpus with every needle written over its end (containsAll
    # true).
    tail = np.frombuffer(" ".join(n1000).encode(), np.uint8)
    data5_all = np.concatenate([data5[: CORPUS_BYTES - len(tail)], tail])
    last5 = n1000[sticky5.groups[-1][-1]].encode()  # a needle of the last sticky group
    corpora5 = {"config 5": data5, "fire-free": clean, "digits (2b)": digits,
                "digits + 1 needle": digits[:half] + last5 + digits[half:]}
    host5 = CppAcEngine(s1000.automaton)
    want5 = {f"contains_any {k}": host5.first_hit(v) >= 0 for k, v in corpora5.items()}
    want5["contains_all true"] = bool(host5.value_presence(data5_all, len(n1000)).all())
    want5["contains_all false"] = bool(host5.value_presence(data5, len(n1000)).all())
    want5["all_matches_arrays"] = host5.matches_arrays(data5)
    want5["count_matches"] = host5.count(data5)
    host_count_ms = []
    for _ in range(3):
        t1 = time.perf_counter()
        host5.count(data5)
        host_count_ms.append((time.perf_counter() - t1) * 1e3)
    host_count_ms = min(host_count_ms)
    check([want5[f"contains_any {k}"] for k in corpora5] == [True, False, False, True]
          and want5["contains_all true"] and not want5["contains_all false"]
          and want5["count_matches"] > 0, f"host C++ answers are not the expected ones: {want5}")
    print(f"grouped path: corpora and host C++ answers in {time.perf_counter() - t0:.1f} s; "
          f"host C++ count {host_count_ms:.1f} ms ({CORPUS_BYTES} bytes, "
          f"{want5['count_matches']} matches, host clock)", flush=True)

    zero_counts()
    t0 = time.perf_counter()
    st5 = {k: s1000.stage(v) for k, v in corpora5.items()}
    staged5_all = s1000.stage(data5_all)
    torch.cuda.synchronize()
    stage5_s = time.perf_counter() - t0

    def under(env, fn):
        def call():
            with mock.patch.dict(os.environ, env):
                return fn()
        return call

    per_group = {"AMT_FUSED_GROUPS": "0", "AMT_FILTER": "0"}
    ops5 = [("count_matches", "main path", lambda: s1000.count_matches(st5["config 5"]))]
    ops5 += [(f"contains_any {k}", "main path", (lambda v=v: s1000.contains_any(v)))
             for k, v in st5.items()]
    ops5 += [
        ("contains_all true", "main path", lambda: s1000.contains_all(staged5_all)),
        ("contains_all false", "main path", lambda: s1000.contains_all(st5["config 5"])),
        ("all_matches_arrays", "main path", lambda: s1000.all_matches_arrays(st5["config 5"])),
        ("count_matches", "AMT_FUSED_GROUPS=0",
         under(per_group, lambda: s1000.count_matches(st5["config 5"]))),
    ]
    ops5 += [(f"contains_any {k}", "AMT_FUSED_GROUPS=0",
              under(per_group, lambda v=v: s1000.contains_any(v))) for k, v in st5.items()]
    ops5 += [(f"contains_any {k}", "AMT_FILTER=0",
              under({"AMT_FILTER": "0"}, lambda v=v: s1000.contains_any(v)))
             for k, v in st5.items()]
    # The kernels each main-path operation must launch, and no other: each
    # extraction runs B15 for every comb32 group, B17 for those with matches,
    # and B13 for every comb16 group.
    n_c32 = sum(type(e) is CombAcEngine for e in eng5.engines)
    n_c16 = sum(type(e) is Comb16AcEngine for e in eng5.engines)
    check((n_c32, n_c16) == (7, 1), f"1,000 needles: {n_c32} comb32 and {n_c16} comb16 groups "
          "(the JAX package's engine has 7 and 1)")
    extract5 = {"comb_count", "comb_states", "matchbits_comb16"}
    expect5 = {
        "count_matches": {"comb16_count_grouped"},
        "contains_any config 5": {"filter_contains", "comb16_contains_grouped"},  # candidates
        "contains_any fire-free": {"filter_contains"},  # no fire: the screen says False
        "contains_any digits (2b)": {"filter_contains", "comb16_contains_grouped"},
        "contains_any digits + 1 needle": {"filter_contains", "comb16_contains_grouped"},
        "contains_all true": extract5,
        "contains_all false": extract5,
        "all_matches_arrays": extract5,
    }
    control_kernels = {
        "AMT_FUSED_GROUPS=0": {"comb_count", "comb16_count", "comb_contains", "comb16_contains"},
        "AMT_FILTER=0": {"comb16_contains_grouped"},
    }
    g_main, g_control = {}, {}
    for op, who, used in run_ops(ops5, want5):
        if who == "main path":
            check(set(used) == expect5[op], f"{op}: launched {used}, expected {expect5[op]}")
            if op == "count_matches":
                check(used == {"comb16_count_grouped": 1}, f"count launched {used}")
            if set(used) == extract5:
                check(used["comb_count"] == n_c32 and used["matchbits_comb16"] == n_c16
                      and 0 < used["comb_states"] <= n_c32, f"{op}: a group was skipped: {used}")
            tally(g_main, used)
        else:
            check(used and set(used) <= control_kernels[who], f"{op} ({who}): launched {used}")
            tally(g_control, used)
    for name in ("comb16_count_grouped", "comb16_contains_grouped", "filter_contains",
                 "comb_count", "comb_states", "matchbits_comb16"):
        check(g_main.get(name, 0) > 0, f"{name} was not launched by the grouped path")
    print(f"grouped path: stage 5 x {CORPUS_BYTES} bytes {stage5_s:.3f} s; every answer == "
          f"host C++ == AMT_FUSED_GROUPS=0 control == AMT_FILTER=0 control; launches "
          f"{g_main}, control {g_control}")

    def launched(fn):
        """(result, wall seconds, kernels launched) of ``fn()``, run with the
        counts set to 0 just before it and read just after."""
        zero_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return out, wall, {k: v for k, v in read_counts().items() if v}

    # -- per-position states at 128 MiB: B5, B12 and B17 ----------------------
    states_main = {}
    for label, eng, sst, want_states, expect in (
            ("bench needles, bitap engine", bitap_eng, st, host.final_states(data),
             {"dense_states": 1}),
            ("30 needles, dense engine", dense30, staged30.device, host30.final_states(data30),
             {"dense_states": 1}),
            ("config 2, comb16 engine", eng2, st2["config 2"].device, host2.final_states(data2),
             {"comb16_states": 1}),
            ("config 5's 300, comb32 engine", eng3, st3["config 5, 300"].device,
             host3.final_states(data3), {"comb_states": 1})):
        fs, wall, used = launched(lambda: eng.final_states_staged(sst))
        check(fs.dtype == np.int32 and np.array_equal(fs, want_states),
              f"final_states ({label}) != host C++")
        check(used == expect, f"final_states ({label}): launched {used}, expected {expect}")
        tally(states_main, used)
        print(f"op final_states {label:34s} {wall * 1e3:10.3f} ms wall  -> {len(fs)} "
              f"states == host C++; launches {used} ({card})", flush=True)

    # -- extraction through the packed states, without the host corpus --------
    extract_main = {}

    def bare(sst):
        return dataclasses.replace(sst, data_np=None)

    for label, eng, sst, expect in (
            ("30 needles, dense engine", dense30, staged30.device,
             {"dense_count": 1, "dense_states": 1}),
            ("config 2, comb16 engine", eng2, st2["config 2"].device,
             {"comb16_count": 1, "comb16_states": 1})):
        bits_route, bits_wall, _ = launched(lambda: eng.match_positions_staged(sst))
        packed, wall, used = launched(lambda: eng.match_positions_staged(bare(sst)))
        _, wall2, _ = launched(lambda: eng.match_positions_staged(bare(sst)))
        _, bits_wall2, _ = launched(lambda: eng.match_positions_staged(sst))
        check(all(np.array_equal(a, b) for a, b in zip(packed, bits_route)) and len(packed[0]) > 0,
              f"packed-states extraction ({label}) != the bitmap route")
        check(used == expect, f"packed-states extraction ({label}): launched {used}")
        tally(extract_main, used)
        print(f"op match_positions_staged {label:26s} without the host corpus {wall * 1e3:.3f} / "
              f"{wall2 * 1e3:.3f} ms, bitmap route {bits_wall * 1e3:.3f} / {bits_wall2 * 1e3:.3f} "
              f"ms wall (turns bitmap, packed, packed, bitmap) -> {len(packed[0])} matches; "
              f"launches {used} ({card})", flush=True)
    # The corpus with every needle in it: every group has matches.
    bare5 = dataclasses.replace(staged5_all, device=bare(staged5_all.device))
    (pends, pvids), wall, used = launched(lambda: s1000.all_matches_arrays(bare5))
    hends, hvids = host5.matches_arrays(data5_all)
    check(np.array_equal(pends, hends) and np.array_equal(pvids, hvids),
          "grouped all_matches_arrays without the host corpus != host C++")
    check(used == {"comb_count": n_c32, "comb_states": n_c32, "comb16_count": n_c16,
                   "comb16_states": n_c16}, f"grouped packed extraction launched {used}")
    tally(extract_main, used)
    print(f"op all_matches_arrays 1,000 needles (all in the corpus), grouped, without the host corpus "
          f"{wall * 1e3:.3f} ms wall -> {len(pends)} matches == host C++; launches {used} ({card})",
          flush=True)
    e48 = DenseAcEngine(m30, device=dev, t_tile=48)
    st48 = e48.stage(data30)
    (n48, (pends, pvids)), wall, used = launched(
        lambda: (e48.count_staged(st48), e48.matches_arrays_staged(st48)))
    hends, hvids = want30["all_matches_arrays"]
    check(n48 == want30["count_matches"] and np.array_equal(pends, hends)
          and np.array_equal(pvids, hvids), "t_tile=48 engine != the default engine")
    check(used == {"dense_count": 2, "dense_states": 1}, f"t_tile=48 engine launched {used}")
    tally(extract_main, used)
    print(f"op count + matches 30 needles, t_tile=48 ({st48.plan}) {wall * 1e3:.3f} ms wall -> "
          f"{n48} matches == default engine; launches {used} ({card})", flush=True)

    # -- the reference scan engine: an empty needle beside 1,000 --------------
    n_ref = [""] + n1000
    data_ref = np.frombuffer(
        synth_corpus(n1000[:500], REFERENCE_BYTES, hit_fraction=0.01, seed=17), np.uint8)
    s_ref = Searcher.build(CASE_SENSITIVE, n_ref)
    eng_ref = s_ref._engine.device_engine()
    check(type(eng_ref) is XlaAcEngine and eng_ref.device == dev,
          f"an empty needle beside 1,000 took {type(eng_ref).__name__}")
    host_ref = CppAcEngine(s_ref.automaton)
    oracle = Searcher.build(CASE_SENSITIVE, n_ref, engine="python")
    staged_ref = s_ref.stage(data_ref)
    check(staged_ref.device is None, "the reference engine staged streams")
    ref_main = {}
    for label, hay, want_ref in (
            ("host C++", data_ref, {
                "count_matches": host_ref.count(data_ref),
                "contains_any": host_ref.first_hit(data_ref) >= 0,
                "contains_all": bool(host_ref.value_presence(data_ref, len(n_ref)).all()),
                "all_matches_arrays": host_ref.matches_arrays(data_ref)}),
            ("python oracle", data_ref[:ORACLE_BYTES], None)):
        if want_ref is None:
            want_ref = {"count_matches": oracle.count_matches(hay),
                        "contains_any": oracle.contains_any(hay),
                        "contains_all": oracle.contains_all(hay),
                        "all_matches_arrays": oracle.all_matches_arrays(hay)}
        h = staged_ref if hay is data_ref else hay
        for op in ("count_matches", "contains_any", "contains_all", "all_matches_arrays"):
            res, wall, used = launched(lambda: getattr(s_ref, op)(h))
            w = want_ref[op]
            ok = (all(np.array_equal(a, b) for a, b in zip(res, w)) if isinstance(w, tuple)
                  else res == w)
            check(ok, f"reference engine {op} != {label}")
            check(not used, f"reference engine {op} launched {used}")
            tally(ref_main, used)
            print(f"op {op:20s} reference engine, {len(hay)} bytes {wall * 1e3:10.3f} ms wall "
                  f"== {label} ({card})", flush=True)
    t0 = time.perf_counter()
    ref_count = eng_ref.count(data_ref)
    torch.cuda.synchronize()
    ref_ms = (time.perf_counter() - t0) * 1e3
    check(ref_count == host_ref.count(data_ref), "reference engine count after timing")
    print(f"time XlaAcEngine count, {len(n_ref)} needles ({s_ref.automaton.n_states} states), "
          f"{REFERENCE_BYTES} bytes: {ref_ms:.1f} ms wall host clock, "
          f"{REFERENCE_BYTES / ref_ms / 1e6:.4f} GB/s ({card})", flush=True)

    # -- IgnoreCase ------------------------------------------------------------
    def scramble(raw, seed):
        """``raw`` with its ASCII letters uppercased at random (seeded)."""
        a = np.frombuffer(raw, np.uint8).copy() if isinstance(raw, bytes) else raw.copy()
        flip = np.random.default_rng(seed).integers(0, 2, size=len(a), dtype=np.uint8) == 1
        a[flip & (a >= 97) & (a <= 122)] -= 32
        return a

    def composed_of(s, label):
        """``s``'s composed engine, built and timed here."""
        t0 = time.perf_counter()
        ci = s._engine._composed(IGNORE_CASE)
        check(ci is not None, f"{label}: no composed engine")
        print(f"IgnoreCase {label}: compose_build {s.automaton.n_states} -> {ci.machine.n_states} "
              f"states + {type(ci.device_engine()).__name__} tables "
              f"{time.perf_counter() - t0:.3f} s host", flush=True)
        return ci

    def host_answers(host, hay, n_values, want=None):
        """count, contains_any, contains_all and all_matches_arrays of the
        host C++ engine ``host`` over ``hay``."""
        want = {} if want is None else want
        want["count_matches"] = host.count(hay)
        want["contains_any"] = host.first_hit(hay) >= 0
        want["contains_all"] = bool(host.value_presence(hay, n_values).all())
        want["all_matches_arrays"] = host.matches_arrays(hay)
        return want

    def oracle_check(s, hay, label):
        """``s`` on ``hay`` (staged, so composed where ``s`` composes) against
        the scalar IgnoreCase oracle."""
        m = s.automaton
        h = s.stage(hay)
        want_n = ac.count_matches(m, hay, IGNORE_CASE)
        want_ends = [x.pos for x in ac.all_matches(m, hay, IGNORE_CASE)]
        got_n = s.count_matches(h)
        check(got_n == want_n, f"{label}: count {got_n} != python oracle {want_n}")
        check(s.all_matches_arrays(h)[0].tolist() == want_ends, f"{label}: ends != python oracle")
        check(s.contains_any(h) == (want_n > 0), f"{label}: contains_any != python oracle")
        print(f"IgnoreCase {label}: {len(hay)} bytes, {want_n} matches == python oracle "
              f"(composed={h.composed})", flush=True)

    PROBES = "TSHİRT ȺSHIRTS SHORTS Å STRAẞE ẞ KSHIRT tshirts SHİRTS ".encode()
    ci_main, ci_control = {}, {}

    # Phase 1: the bench needles under IgnoreCase at 128 MiB, case-scrambled.
    t0 = time.perf_counter()
    data_ci = scramble(data, 31)
    s_ci = Searcher.build(IGNORE_CASE, NEEDLES)
    miss_ci = Searcher.build(IGNORE_CASE, ["tshirt9", "shorts9"])  # no digit in the corpus
    absent_ci = Searcher.build(IGNORE_CASE, NEEDLES + ["shorts9"])
    ci1 = composed_of(s_ci, "bench needles")
    for s, label in ((miss_ci, "miss needles"), (absent_ci, "absent needle")):
        composed_of(s, label)
    eng_ci = ci1.device_engine()
    lay_ci = eng_ci.bitap if isinstance(eng_ci, BitapAcEngine) else None
    check(lay_ci is not None and lay_ci.ci and lay_ci.trap is None
          and any(w.trap_endmask for w in lay_ci.words),
          f"IgnoreCase bench: not the byte-class bitap with an embedded trap ({type(eng_ci)})")
    with mock.patch.dict(os.environ, {"AMT_BITAP": "0"}):  # the control: B1 on composed tables
        ci1_dense = MatchEngine(ci1.machine, device=dev)
        check(type(ci1_dense.device_engine()) is DenseAcEngine, "IgnoreCase control is not dense")
    host_ci = CppAcEngine(ci1.machine)
    want_ci = host_answers(host_ci, data_ci, len(NEEDLES))
    want_ci["contains_any miss"] = CppAcEngine(miss_ci._engine._ci.machine).first_hit(data_ci) >= 0
    want_ci["contains_all false"] = bool(CppAcEngine(absent_ci._engine._ci.machine).value_presence(
        data_ci, len(NEEDLES) + 1).all())
    check(want_ci["count_matches"] > 0 and want_ci["contains_any"] and want_ci["contains_all"]
          and not want_ci["contains_any miss"] and not want_ci["contains_all false"],
          f"IgnoreCase host C++ answers are not the expected ones")
    check(want_ci["count_matches"] == got, "IgnoreCase count != the CaseSensitive count of the "
          "unscrambled corpus")
    print(f"IgnoreCase bench: corpus, engines and host C++ answers in "
          f"{time.perf_counter() - t0:.1f} s; layout {lay_ci.n_words} word, trap_endmask "
          f"{[hex(w.trap_endmask) for w in lay_ci.words]}", flush=True)
    zero_counts()
    t0 = time.perf_counter()
    staged_ci = s_ci.stage(data_ci)
    torch.cuda.synchronize()
    stage_ci_s = time.perf_counter() - t0
    staged_miss_ci = miss_ci.stage(data_ci)
    staged_absent_ci = absent_ci.stage(data_ci)
    check(staged_ci.composed and not any(read_counts().values()),
          "IgnoreCase staging is not composed (or launched a kernel)")
    st_ci = staged_ci.device
    print(f"IgnoreCase bench: stage {CORPUS_BYTES} bytes {stage_ci_s:.3f} s ({st_ci.plan})",
          flush=True)
    ctrl = lambda op: (lambda: getattr(ci1_dense, op)(staged_ci, CASE_SENSITIVE))  # noqa: E731
    ops_ci = [
        ("count_matches", "main path", lambda: s_ci.count_matches(staged_ci)),
        ("count_matches", "AMT_BITAP=0", ctrl("count")),
        ("contains_any", "main path", lambda: s_ci.contains_any(staged_ci)),
        ("contains_any", "AMT_BITAP=0", ctrl("contains_any")),
        ("contains_any miss", "main path", lambda: miss_ci.contains_any(staged_miss_ci)),
        ("contains_all", "main path", lambda: s_ci.contains_all(staged_ci)),
        ("contains_all", "AMT_BITAP=0", lambda: bool(ci1_dense.value_presence(
            staged_ci, CASE_SENSITIVE).all())),
        ("contains_all false", "main path", lambda: absent_ci.contains_all(staged_absent_ci)),
        ("all_matches_arrays", "main path", lambda: s_ci.all_matches_arrays(staged_ci)),
        ("all_matches_arrays", "AMT_BITAP=0",
         lambda: dataclasses.astuple(ci1_dense.matches(staged_ci, CASE_SENSITIVE))[:2]),
    ]
    expect_ci = {"count_matches": {"bitap_count_trap": 1},
                 "contains_any": {"bitap_contains_trap": 1},
                 "contains_any miss": {"bitap_contains_trap": 1},
                 "contains_all": {"bitap_presence_trap": 1},
                 "contains_all false": {"bitap_presence_trap": 1},
                 "all_matches_arrays": {"matchbits": 1}}  # trap layouts take the dense step
    for op, who, used in run_ops(ops_ci, want_ci):
        if who == "main path":
            check(used == expect_ci[op], f"IgnoreCase {op}: launched {used}, "
                  f"expected {expect_ci[op]}")
            tally(ci_main, used)
        else:
            check(used and set(used) <= {"dense_count", "dense_contains", "matchbits"},
                  f"IgnoreCase {op} ({who}): launched {used}")
            tally(ci_control, used)
    pre = np.concatenate([data_ci[:ORACLE_BYTES], np.frombuffer(PROBES, np.uint8)])
    oracle_check(s_ci, pre.tobytes(), "bench needles, 64 KiB + probes")

    # Phase 2: TSHİRT written into < 1% of the live streams (host recount of
    # the trapped streams) and into > 1% (the dense fallback, B1).
    L_ci, S_ci = st_ci.plan.emit_len, st_ci.plan.n_streams
    tword = "TSHİRT".encode()

    def with_traps(n_hit, seed):
        a = data_ci.copy()
        for s in np.random.default_rng(seed).choice(S_ci, n_hit, replace=False):
            a[s * L_ci + 100: s * L_ci + 100 + len(tword)] = np.frombuffer(tword, np.uint8)
        return a

    # 100 of 32768 streams is under the 1% the host recount takes.
    for label, n_hit, route in (("few", min(100, S_ci // 200), "host recount"),
                                ("many", min(1000, S_ci), "dense fallback")):
        hay = with_traps(n_hit, 40 + n_hit)
        want_t = host_answers(host_ci, hay, len(NEEDLES))
        sst = s_ci.stage(hay)
        _, trap = eng_ci.stream_counts(sst.device)
        trapped = eng_ci._trapped_streams(trap.cpu().numpy(), sst.device)
        n_trapped = int((trap.cpu().numpy()[sst.device.live_np] != 0).sum())
        took = "host recount" if trapped is not None else "dense fallback"
        check(took == route and n_trapped >= n_hit,
              f"trap corpus ({label}): {n_trapped} trapped streams took the {took}")
        count_kernels = {"bitap_count_trap": 1, **({"dense_count": 1} if route != "host recount"
                                                   else {})}
        expect_t = {"count_matches": count_kernels, "contains_any": {"bitap_contains_trap": 1},
                    "contains_all": {"bitap_presence_trap": 1, "matchbits": 1},
                    "all_matches_arrays": {"matchbits": 1}}
        check(eng_ci.needle_presence_staged(sst.device) is None,
              f"trap corpus ({label}): presence flags did not decline")
        ops_t = [(op, f"trapped {label}", (lambda op=op: getattr(s_ci, op)(sst)))
                 for op in expect_t]
        for op, who, used in run_ops(ops_t, want_t):
            check(used == expect_t[op], f"trap corpus ({label}) {op}: launched {used}, "
                  f"expected {expect_t[op]}")
            tally(ci_main, used)
        print(f"IgnoreCase trap corpus ({label}): TSHİRT in {n_hit} streams, {n_trapped} of "
              f"{int(sst.device.live_np.sum())} live streams trapped -> {took}; every answer == "
              f"host C++ on the composed machine", flush=True)
    oracle_check(s_ci, (pre.tobytes() + "KSHIRT İ Ⱥ Å ẞ ".encode()) * 2,
                 "bench needles, probes with traps")

    # Phase 3: config 2 under IgnoreCase, the composed machine on comb16.
    t0 = time.perf_counter()
    data2_ci = scramble(data2, 32)
    s2_ci = Searcher.build(IGNORE_CASE, c2)
    absent2_ci = Searcher.build(IGNORE_CASE, c2 + ["shorts9"])
    ci2 = composed_of(s2_ci, "config 2")
    composed_of(absent2_ci, "config 2 + absent")
    eng2_ci = ci2.device_engine()
    check(type(eng2_ci) is Comb16AcEngine and eng2_ci._filter_tables is None,
          f"IgnoreCase config 2 took {type(eng2_ci).__name__} (or a screen)")
    host2_ci = CppAcEngine(ci2.machine)
    want2_ci = host_answers(host2_ci, data2_ci, len(c2))
    want2_ci["contains_all false"] = bool(CppAcEngine(absent2_ci._engine._ci.machine)
                                          .value_presence(data2_ci, len(c2) + 1).all())
    check(want2_ci["count_matches"] == got2 and want2_ci["contains_all"]
          and not want2_ci["contains_all false"], "IgnoreCase config 2 host answers")
    staged2_ci = s2_ci.stage(data2_ci)
    staged2_absent = absent2_ci.stage(data2_ci)
    torch.cuda.synchronize()
    print(f"IgnoreCase config 2: {ci2.machine.n_states} composed states, comb16 rows "
          f"{eng2_ci.c16.rows_c}+{eng2_ci.c16.rows_a}; corpora, host answers and staging in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    ops2_ci = [(op, "main path", (lambda op=op: getattr(s2_ci, op)(staged2_ci)))
               for op in ("count_matches", "contains_any", "contains_all", "all_matches_arrays")]
    ops2_ci.append(("contains_all false", "main path", lambda: absent2_ci.contains_all(
        staged2_absent)))
    # The absent needle's composed machine (548 states) overflows comb16.
    absent2_kernels = ({"comb_count", "comb_states"}
                       if type(absent2_ci._engine._ci.device_engine()) is CombAcEngine
                       else {"matchbits_comb16"})
    expect2_ci = {"count_matches": {"comb16_count"}, "contains_any": {"comb16_contains"},
                  "contains_all": {"matchbits_comb16"}, "contains_all false": absent2_kernels,
                  "all_matches_arrays": {"matchbits_comb16"}}
    for op, who, used in run_ops(ops2_ci, want2_ci):
        check(set(used) == expect2_ci[op], f"IgnoreCase config 2 {op}: launched {used}")
        tally(ci_main, used)
    oracle_check(s2_ci, data2_ci[:ORACLE_BYTES].tobytes() + PROBES, "config 2, 64 KiB + probes")

    # Phase 4: the lowering path, config 5's first 600 needles at 32 MiB.
    n600 = config5_needles(600)
    s600 = Searcher.build(IGNORE_CASE, n600)
    t0 = time.perf_counter()
    check(s600._engine._composed(IGNORE_CASE) is None,
          "config 5's 600 needles composed: the grouped engine would scan them case-sensitively")
    gate_s = time.perf_counter() - t0
    data600 = scramble(synth_corpus(n600, LOWERING_BYTES, hit_fraction=0.01, seed=15), 33)
    t0 = time.perf_counter()
    lt600 = utf8.lower_transform(data600)
    lower_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    staged600 = s600.stage(data600)
    torch.cuda.synchronize()
    stage600_s = time.perf_counter() - t0
    eng600 = s600._engine.device_engine()
    check(type(eng600) is GroupedAcEngine and not staged600.composed
          and staged600.lowered is not None, "config 5's 600 needles: not the lowering path")
    host600 = CppAcEngine(s600.automaton)
    want600 = {"count_matches": host600.count(lt600.lowered)}
    e6, v6 = host600.matches_arrays(lt600.lowered)
    want600["all_matches_arrays"] = (lt600.map_ends_to_raw(e6) if len(e6) else e6, v6)
    check(want600["count_matches"] > 0, "config 5's 600 needles: no match")
    print(f"IgnoreCase lowering path: config 5's 600 needles ({s600.automaton.n_states} states): "
          f"compose gate {gate_s:.3f} s host (declined); lower_transform {LOWERING_BYTES} bytes "
          f"{lower_s * 1e3:.1f} ms host; stage (lowering, grouped build of {eng600.n_groups} "
          f"groups, device staging) {stage600_s:.1f} s", flush=True)
    ops600 = [(op, "main path", (lambda op=op: getattr(s600, op)(staged600)))
              for op in ("count_matches", "all_matches_arrays")]
    for op, who, used in run_ops(ops600, want600):
        check(used and set(used) <= {"comb16_count_grouped", "comb_count", "comb_states",
                                     "matchbits_comb16", "comb16_count", "comb16_states"},
              f"lowering path {op}: launched {used}")
        tally(ci_main, used)
    oracle_check(s600, data600[:ORACLE_BYTES].tobytes() + PROBES, "config 5's 600, 64 KiB")

    # Phase 5: B2, B4 and B7 with trap tables against their plain versions.
    reg_needles = ["tshirt", "shirts", "shorts", "kilo", "café"]
    for seed, (label, needles) in enumerate((("trapless", ["dress", "shoe", "glove"]),
                                             ("embedded trap", NEEDLES),
                                             ("trap register", reg_needles))):
        m = machine_of(needles)
        cm = case_dfa.compose_build(list(zip(m.needles, m.values)), machine=m)
        e = BitapAcEngine(cm, layout=plan_bitap_ci(cm, max_words=2), device=dev)
        lay_k = e.bitap
        shape = (any(w.trap_endmask for w in lay_k.words), lay_k.trap is not None)
        check(shape == {"trapless": (False, False), "embedded trap": (True, False),
                        "trap register": (False, True)}[label], f"{label}: layout {shape}")
        hay = scramble(synth_corpus(needles, CHECK_BYTES, hit_fraction=0.02, seed=50 + seed), seed)
        hay = np.concatenate([hay, np.frombuffer(PROBES * 3, np.uint8)])
        sst = e.stage(hay)
        suffix = "_trap" if lay_k.has_trap else ""
        kargs, sargs = e._kernel_args(sst), e.sticky_bitap_args(sst)
        for name, kernel, plain, args in (
                ("bitap_count", K.bitap_count, K.bitap_count_plain, kargs),
                ("bitap_contains", K.bitap_contains, K.bitap_contains_plain, sargs),
                ("bitap_presence", K.bitap_presence, K.bitap_presence_plain, sargs)):
            k, p = kernel(*args), plain(*args)
            for a, b in zip(k if isinstance(k, tuple) else (k,), p if isinstance(p, tuple) else (p,)):
                same(name + suffix, a, b, f"IgnoreCase {label}")
        hci = CppAcEngine(cm)
        n = e.count_staged(sst)
        check(n == hci.count(hay) and e.contains_staged(sst) == (hci.first_hit(hay) >= 0),
              f"IgnoreCase {label}: answers != host C++")
        pres = e.needle_presence_staged(sst)
        check((pres is None) == lay_k.has_trap, f"IgnoreCase {label}: presence with a trap")
        print(f"check bitap{suffix:5s} IgnoreCase {label:14s} V={lay_k.n_words} VT="
              f"{len(lay_k.all_words())} count={n} == host C++ ok", flush=True)
    # The trap-register layout's kernels at the bench shape, for timing.
    m_reg = machine_of(reg_needles)
    cm_reg = case_dfa.compose_build(list(zip(m_reg.needles, m_reg.values)), machine=m_reg)
    eng_reg = BitapAcEngine(cm_reg, layout=plan_bitap_ci(cm_reg, max_words=2), device=dev)
    check(eng_reg.adopt_staged(st_ci) is st_ci, "trap register engine cannot adopt the staging")
    for name in ("bitap_count_trap", "bitap_contains_trap", "bitap_presence_trap"):
        check(ci_main.get(name, 0) > 0, f"{name} was not launched by the IgnoreCase path")

    # -- timing at the main paths' shapes --------------------------------------
    def timed(fn, runs):
        fn()  # warm-up
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(runs):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / runs

    shape = f"T={st.plan.time_len} S={st.plan.n_streams}"

    def report(name, what, ms):
        print(f"time {name:16s} {what:44s} {ms:10.3f} ms  {CORPUS_BYTES / ms / 1e6:9.2f} GB/s "
              f"({shape}; {card})")

    def first_hit_steps(bits_eng, sst):
        """int64 [S]: the steps each stream of ``sst`` must read to answer
        containsAny for ``bits_eng``'s machine: up to its first match end
        (from the hit bitmap, or comb32's packed states), else its ``vend``."""
        vend = sst.vend.long()
        if isinstance(bits_eng, CombAcEngine):
            hit = (K.comb_states(*bits_eng.states_args(sst)) >> 27) > 0  # [T, S]
            t = torch.argmax(hit.int(), dim=0)  # first hit (0 when none)
            return torch.where(hit.any(0) & (t < vend), t + 1, vend).clamp(
                max=sst.plan.time_len)
        _, bits = K.matchbits(*bits_eng.bits_args(sst))
        w = bits.long() & 0xFFFFFFFF  # [T/32, S]
        nz = w != 0
        word = torch.argmax(nz.int(), dim=0)  # first non-zero word (0 when none)
        low = w.gather(0, word.unsqueeze(0)).squeeze(0)
        bit = torch.log2((low & -low).double().clamp(min=1)).long()
        t = word * 32 + bit
        return torch.where(nz.any(0) & (t < vend), t + 1, vend).clamp(max=sst.plan.time_len)

    def bound(stream_bytes, other_bytes, ops):
        """(least ms, what bounds it): each input byte read once and each
        output byte written once at the HBM rate, against ``ops`` 32-bit
        operations at the ALU rate."""
        b = (stream_bytes + other_bytes) / HBM_BYTES_PER_S * 1e3
        o = ops / ALU_OPS_PER_S * 1e3
        return (b, "bytes") if b >= o else (o, "operations")

    def table_bytes(args):
        tabs = [a for a in args[1:] if torch.is_tensor(a)]
        for a in args[1:]:  # the grouped kernels' tables
            if hasattr(a, "gscal"):
                tabs += [a.classmap, a.comb, a.aux, a.root_row, a.segtable, a.gscal]
        return sum(a.numel() * a.element_size() for a in tabs)

    def n_live_bytes(sst):
        return int(sst.vend.clamp(max=sst.plan.time_len).long().sum())

    miss_eng = miss_dense._engine.device_engine()
    st_c2, st_digits = st2["config 2"].device, st2["digits (2b)"].device
    S = st.plan.n_streams
    T = st.plan.time_len
    need_bench = int(first_hit_steps(bitap_eng, st).sum())
    need_ci = int(first_hit_steps(eng_ci, st_ci).sum())
    VT_ci, VT_reg = len(lay_ci.all_words()), len(eng_reg.bitap.all_words())
    need_digits = int(first_hit_steps(eng2, st_digits).sum())
    need_c2 = int(first_hit_steps(eng2, st_c2).sum())
    T2 = st_c2.plan.time_len
    st5c, st5d = st5["config 5"].device, st5["digits (2b)"].device
    G5, Y5 = f5.n_groups, y5.n_groups
    # B11 must read each stream up to the first match of any group's needle.
    need5 = int(torch.stack([first_hit_steps(e, st5c) for e in eng5.engines]).min(0).values.sum())
    need5d = n_live_bytes(st5d)
    st3c, st3d = st3["config 5, 300"].device, st3["digits (2b)"].device
    need3 = int(first_hit_steps(eng3, st3c).sum())
    need3d = int(first_hit_steps(eng3, st3d).sum())
    T3 = st3c.plan.time_len
    # (name, kernel, plain, args, what, stream bytes the function needs,
    #  output bytes, operations: one 32-bit state update per byte and word)
    timings = {}
    rows = (
        ("bitap_count", K.bitap_count, K.bitap_count_plain, bitap_eng._kernel_args(st),
         "bench needles", n_live_bytes(st), 4 * S,
         n_live_bytes(st) * bitap_eng.bitap.n_words),
        ("dense_count", K.dense_count, K.dense_count_plain, dense_eng._kernel_args(st),
         "bench needles", n_live_bytes(st), 4 * S, n_live_bytes(st)),
        ("dense_contains", K.dense_contains, K.dense_contains_plain, dense_eng.sticky_args(st),
         "bench needles", need_bench, 4 * S, need_bench),
        ("dense_contains", K.dense_contains, K.dense_contains_plain,
         miss_eng.sticky_args(staged_miss.device), "miss needles, full scan",
         n_live_bytes(staged_miss.device), 4 * S, n_live_bytes(staged_miss.device)),
        ("bitap_contains", K.bitap_contains, K.bitap_contains_plain,
         bitap_eng.sticky_bitap_args(st), "bench needles", need_bench, 4 * S,
         need_bench * bitap_eng.bitap.n_words),
        ("bitap_presence", K.bitap_presence, K.bitap_presence_plain,
         bitap_eng.sticky_bitap_args(st), "bench needles", n_live_bytes(st),
         4 * S * bitap_eng.bitap.n_words, n_live_bytes(st) * bitap_eng.bitap.n_words),
        ("matchbits", K.matchbits, K.matchbits_plain, bitap_eng.bits_args(st),
         "bench needles, bitap step", T * S, 4 * S + T // 32 * S * 4, T * S),
        ("matchbits", K.matchbits, K.matchbits_plain, dense_eng.bits_args(st),
         "bench needles, dense step", T * S, 4 * S + T // 32 * S * 4, T * S),
        ("comb16_count", K.comb16_count, K.comb16_count_plain, eng2._kernel_args(st_c2),
         "config 2", n_live_bytes(st_c2), 4 * S, n_live_bytes(st_c2)),
        ("comb16_contains", K.comb16_contains, K.comb16_contains_plain,
         eng2.sticky_args(st_digits), "config 2, digits corpus: full scan", need_digits, 4 * S,
         need_digits),
        ("comb16_contains", K.comb16_contains, K.comb16_contains_plain,
         eng2.sticky_args(st_c2), "config 2 corpus: stops at the first match", need_c2, 4 * S,
         need_c2),
        ("matchbits_comb16", K.matchbits, K.matchbits_plain, eng2.bits_args(st_c2),
         "config 2, comb16 step", T2 * S, 4 * S + T2 // 32 * S * 4, T2 * S),
        ("filter_contains", K.filter_contains, K.filter_contains_plain,
         (st_c2.streams, st_c2.vend, *eng2._filter_tables.args()), "config 2",
         n_live_bytes(st_c2), 8 * S, n_live_bytes(st_c2) // 2 * (lay.n_words + 2 * len(lay.shorts))),
        ("filter_contains", K.filter_contains, K.filter_contains_plain,
         (st5c.streams, st5c.vend, *eng5._filter_tables.args()), "config 5, 12 words",
         n_live_bytes(st5c), 8 * S, n_live_bytes(st5c) // 2 * (lay5.n_words + 2 * len(lay5.shorts))),
        ("comb16_count_grouped", K.comb16_count_grouped, K.comb16_count_grouped_plain,
         (st5c.streams, st5c.warm, st5c.vend, f5), "config 5", n_live_bytes(st5c), 4 * S,
         n_live_bytes(st5c) * G5),
        ("comb16_contains_grouped", K.comb16_contains_grouped, K.comb16_contains_grouped_plain,
         (st5d.streams, st5d.vend, y5), "config 5, digits corpus: full scan", need5d, 4 * S,
         need5d * Y5),
        ("comb16_contains_grouped", K.comb16_contains_grouped, K.comb16_contains_grouped_plain,
         (st5c.streams, st5c.vend, y5), "config 5 corpus: stops at the first match", need5,
         4 * S, need5 * Y5),
        ("comb_count", K.comb_count, K.comb_count_plain, eng3._kernel_args(st3c),
         "config 5, 300 needles", n_live_bytes(st3c), 4 * S, n_live_bytes(st3c)),
        ("comb_contains", K.comb_contains, K.comb_contains_plain, eng3.sticky_args(st3d),
         "300 needles, digits corpus: full scan", need3d, 4 * S, need3d),
        ("comb_contains", K.comb_contains, K.comb_contains_plain, eng3.sticky_args(st3c),
         "300 needles, config 5 corpus: first match", need3, 4 * S, need3),
        ("comb_states", K.comb_states, K.comb_states_plain, eng3.states_args(st3c),
         "config 5, 300 needles", T3 * S, 4 * T3 * S, T3 * S),
        ("dense_states", K.dense_states, K.dense_states_plain, bitap_eng.states_args(st),
         "bench needles", T * S, 4 * T * S, T * S),
        ("comb16_states", K.comb16_states, K.comb16_states_plain, eng2.states_args(st_c2),
         "config 2", T2 * S, 4 * T2 * S, T2 * S),
        ("bitap_count_trap", K.bitap_count, K.bitap_count_plain, eng_ci._kernel_args(st_ci),
         "IgnoreCase bench needles, embedded trap", n_live_bytes(st_ci), 8 * S,
         n_live_bytes(st_ci) * VT_ci),
        ("bitap_count_trap", K.bitap_count, K.bitap_count_plain, eng_reg._kernel_args(st_ci),
         "IgnoreCase 5 needles, trap register", n_live_bytes(st_ci), 8 * S,
         n_live_bytes(st_ci) * VT_reg),
        ("bitap_contains_trap", K.bitap_contains, K.bitap_contains_plain,
         eng_ci.sticky_bitap_args(st_ci), "IgnoreCase bench needles, embedded trap", need_ci,
         8 * S, need_ci * VT_ci),
        ("bitap_presence_trap", K.bitap_presence, K.bitap_presence_plain,
         eng_ci.sticky_bitap_args(st_ci), "IgnoreCase bench needles, embedded trap",
         n_live_bytes(st_ci), 4 * S * VT_ci, n_live_bytes(st_ci) * VT_ci),
        ("bitap_presence_trap", K.bitap_presence, K.bitap_presence_plain,
         eng_reg.sticky_bitap_args(st_ci), "IgnoreCase 5 needles, trap register",
         n_live_bytes(st_ci), 4 * S * VT_reg, n_live_bytes(st_ci) * VT_reg),
    )
    for name, kernel, plain, args, what, sbytes, obytes, ops in rows:
        k, p = kernel(*args), plain(*args)
        for a, b in zip(k if isinstance(k, tuple) else (k,), p if isinstance(p, tuple) else (p,)):
            same(name, a, b, f"{what} at the main path's shape")
        ms = timed(lambda: kernel(*args), KERNEL_RUNS)
        plain_ms = timed(lambda: plain(*args), PLAIN_RUNS)
        bms, by = bound(sbytes, obytes + table_bytes(args), ops)
        report(name, f"kernel, {what}", ms)
        report(name, f"plain, {what}", plain_ms)
        print(f"bound {name:16s} {what:44s} {bms:10.4f} ms by {by} ({sbytes} stream bytes; "
              f"{ms / bms:.1f}x the bound)")
        timings[(name, what)] = (ms, plain_ms, bms, by)

    # B8 against B1 on the dense path's 30 needles, which both engines hold.
    comb30 = Comb16AcEngine(m30, device=dev)
    st30 = staged30.device
    check(comb30.adopt_staged(st30) is st30, "the 30-needle engines plan different streams")
    ref30 = want30["count_matches"]
    check(dense30.count_staged(st30) == comb30.count_staged(st30) == ref30,
          "30-needle counts differ")
    same("comb16_count", comb30.stream_counts(st30), comb30.stream_counts_plain(st30),
         "30 needles")
    turns = []
    for label, eng in (("B1", dense30), ("B8", comb30), ("B8", comb30), ("B1", dense30)):
        turns.append((label, timed(lambda: eng.stream_counts(st30), KERNEL_RUNS)))
    b1 = [ms for label, ms in turns if label == "B1"]
    b8 = [ms for label, ms in turns if label == "B8"]
    print(f"time 30 needles ({dense30.comp.n_states} states, k={dense30.comp.k}, dense packing "
          f"{dense30.comp.packing}; comb16 rows {comb30.c16.rows_c}+{comb30.c16.rows_a}), "
          f"count {ref30}: B1 dense_count {b1[0]:.4f} / {b1[1]:.4f} ms, B8 comb16_count "
          f"{b8[0]:.4f} / {b8[1]:.4f} ms (turns B1, B8, B8, B1; {card})")

    # B9 against the per-group passes it replaces (the AMT_FUSED_GROUPS=0
    # control: one B15 or B8 launch per group), on the config-5 corpus.
    check(eng5.count_staged(st5c) == want5["count_matches"], "grouped count after timing")
    turns5 = []
    for label, fn in (("B9", lambda: eng5.stream_counts(st5c)),
                      ("per-group", lambda: [e.stream_counts(st5c) for e in eng5.engines]),
                      ("per-group", lambda: [e.stream_counts(st5c) for e in eng5.engines]),
                      ("B9", lambda: eng5.stream_counts(st5c))):
        turns5.append((label, timed(fn, KERNEL_RUNS)))
    b9 = [ms for label, ms in turns5 if label == "B9"]
    b8s = [ms for label, ms in turns5 if label == "per-group"]
    print(f"time 1,000 needles, count: B9 over {G5} uniform groups {b9[0]:.4f} / {b9[1]:.4f} ms, "
          f"per-group passes over {eng5.n_groups} groups {b8s[0]:.4f} / {b8s[1]:.4f} ms (turns B9, "
          f"per-group, per-group, B9; {card}); host C++ count {host_count_ms:.1f} ms host clock")

    # The extraction path's stages after the B6 kernel (bitap step).
    _, bits = K.matchbits(*bitap_eng.bits_args(st))
    flat = bits.reshape(-1)

    def compact():
        gi = torch.nonzero(flat).squeeze(1)
        return torch.stack([gi, flat[gi].long()]).cpu()

    for _ in range(2):
        compact()
    t0 = time.perf_counter()
    for _ in range(KERNEL_RUNS):
        wv = compact()
    compact_ms = (time.perf_counter() - t0) * 1e3 / KERNEL_RUNS
    print(f"time compaction (torch.nonzero over {flat.numel()} words + gather + one copy of "
          f"{wv.shape[1]} words to the host) {compact_ms:.3f} ms host clock ({card})")
    for label, eng, sst, n in (("bench", bitap_eng, st, got), ("config 2", eng2, st_c2, got2),
                               ("config 5, 300, comb32", eng3, st3c, want3["count_matches"]),
                               ("config 5, grouped", eng5, st5c, want5["count_matches"])):
        t0 = time.perf_counter()
        for _ in range(3):
            eng.matches_arrays_staged(sst)
        extract_ms = (time.perf_counter() - t0) * 1e3 / 3
        print(f"time all_matches_arrays staged, {label} (kernels + compaction + host expansion "
              f"of {n} matches) {extract_ms:.3f} ms host clock ({card})")

    # name: (source, TPU kernel it replaces, wrapper, the timing of its main path)
    table = {
        "bitap_count": ("bitap_count.cu", "bitap_scan.py:352", "bench needles"),
        "dense_count": ("dense_count.cu", "pallas_scan.py:281", "bench needles"),
        "dense_contains": ("dense_contains.cu", "pallas_scan.py:426", "bench needles"),
        "bitap_contains": ("bitap_contains.cu", "bitap_scan.py:466", "bench needles"),
        "matchbits": ("matchbits.cu", "pallas_scan.py:1174", "bench needles, bitap step"),
        "bitap_presence": ("bitap_contains.cu", "bitap_scan.py:551", "bench needles"),
        "comb16_count": ("comb16_scan.cu", "comb16_scan.py:610", "config 2"),
        "comb16_contains": ("comb16_scan.cu", "comb16_scan.py:860",
                            "config 2, digits corpus: full scan"),
        "matchbits_comb16": ("matchbits.cu", "comb16_scan.py:1382", "config 2, comb16 step"),
        "filter_contains": ("filter_contains.cu", "filter_scan.py:191", "config 2"),
        "comb16_count_grouped": ("comb16_grouped.cu", "comb16_scan.py:682", "config 5"),
        "comb16_contains_grouped": ("comb16_grouped.cu", "comb16_scan.py:778",
                                    "config 5, digits corpus: full scan"),
        "comb_count": ("comb_scan.cu", "comb_scan.py:389", "config 5, 300 needles"),
        "comb_contains": ("comb_scan.cu", "comb_scan.py:466",
                          "300 needles, digits corpus: full scan"),
        "comb_states": ("comb_scan.cu", "comb_scan.py:529", "config 5, 300 needles"),
        "dense_states": ("dense_count.cu", "pallas_scan.py:496", "bench needles"),
        "comb16_states": ("comb16_scan.cu", "comb16_scan.py:917", "config 2"),
        "bitap_count_trap": ("bitap_count.cu", "bitap_scan.py:352",
                             "IgnoreCase bench needles, embedded trap"),
        "bitap_contains_trap": ("bitap_contains.cu", "bitap_scan.py:466",
                                "IgnoreCase bench needles, embedded trap"),
        "bitap_presence_trap": ("bitap_contains.cu", "bitap_scan.py:551",
                                "IgnoreCase bench needles, embedded trap"),
    }
    # Launches counted by the wrappers during the main paths, and apart from
    # them the controls'.
    launches, control = {}, {}
    for path in (bench_main, dense_main, c16_main, c32_main, g_main, states_main, extract_main,
                 ref_main, ci_main):
        tally(launches, path)
    for path in (bench_control, c16_control, g_control, ci_control):
        tally(control, path)
    kernels = []
    for name, (src, where, what) in table.items():
        ms, plain_ms, bms, by = timings[(name, what)]
        entry = {
            "name": name, "route": "cuda", "source": f"alfred_margaret_tpu_torch/csrc/{src}",
            "replaces": f"alfred_margaret_tpu/ops/{where}", "launches": launches.get(name, 0),
            "control_launches": control.get(name, 0),
            "max_abs_err": max_err[name], "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "library_ms": None,  # no PyTorch call runs an automaton
        }
        if name == "dense_contains":
            entry["ms_full_scan"], entry["plain_ms_full_scan"], entry["bound_ms_full_scan"], _ = (
                timings[(name, "miss needles, full scan")])
        if name == "matchbits":
            entry["ms_dense_step"], entry["plain_ms_dense_step"], _, _ = timings[
                (name, "bench needles, dense step")]
        if name == "comb16_contains":
            entry["ms_first_match"], entry["plain_ms_first_match"], entry[
                "bound_ms_first_match"], _ = timings[(name, "config 2 corpus: stops at the first match")]
        if name == "comb16_count":
            entry["ms_30_needles"], entry["ms_30_needles_b1"] = b8, b1
        if name == "filter_contains":
            entry["ms_12_words"], entry["plain_ms_12_words"], entry["bound_ms_12_words"], _ = (
                timings[(name, "config 5, 12 words")])
        if name == "comb16_count_grouped":
            entry.update(groups=G5, ms_turns=b9, ms_per_group_control=b8s,
                         per_group_passes=eng5.n_groups, host_cpp_count_ms=host_count_ms)
        if name == "comb_contains":
            entry["ms_first_match"], entry["plain_ms_first_match"], entry[
                "bound_ms_first_match"], _ = timings[(name, "300 needles, config 5 corpus: first match")]
        if name in ("bitap_count_trap", "bitap_presence_trap"):
            entry["ms_trap_register"], entry["plain_ms_trap_register"], entry[
                "bound_ms_trap_register"], _ = timings[(name, "IgnoreCase 5 needles, trap register")]
        if name == "comb16_contains_grouped":
            entry["groups"] = Y5
            entry["ms_first_match"], entry["plain_ms_first_match"], entry[
                "bound_ms_first_match"], _ = timings[(name, "config 5 corpus: stops at the first match")]
        kernels.append(entry)
    for name in ("dense_states", "comb16_states"):
        check(launches.get(name, 0) > 0, f"{name} was not launched by the states paths")

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": gpu, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
