"""Drive the PyTorch port's Searcher once on one NVIDIA GPU.

Run from the repository root on a host with one CUDA card (an H100):

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``alfred_margaret_tpu_torch/csrc``
(one ``nvcc`` per source, all at once) and checks each of the ten kernels
against its plain torch version on the card on twelve machines, and the
engines' answers against the port's host C++ engine.  Then it drives three
main paths over 128 MiB corpora, each with the kernels' launch counts set to
0 just before it and read just after (the controls' launches are read apart):

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
  comb16 step, B13).

Every answer must equal the host C++ engine's (and the control's), and every
kernel of a path must have been launched by it.  Last it times every kernel
and its plain version with CUDA events, and B8 against B1 on one 30-needle
set that both engines hold.  Any failure raises and the exit code is
non-zero.  Without a CUDA device it exits non-zero before printing a result.

The last three lines of standard output are the kernels' JSON summary, the
card's ``nvidia-smi`` name and power limit, and ``{"ok": true, "device":
{...}}``.
"""

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

    from alfred_margaret_tpu_torch import CASE_SENSITIVE, Searcher, toolchain_report
    from alfred_margaret_tpu_torch import kernels as K
    from alfred_margaret_tpu_torch.bench.dataformat import synth_corpus
    from alfred_margaret_tpu_torch.kernels import build
    from alfred_margaret_tpu_torch.models import ac
    from alfred_margaret_tpu_torch.native import build as native_build
    from alfred_margaret_tpu_torch.native.cpp_engine import CppAcEngine
    from alfred_margaret_tpu_torch.ops.bitap_scan import BitapAcEngine, plan_bitap
    from alfred_margaret_tpu_torch.ops.comb16_scan import Comb16AcEngine
    from alfred_margaret_tpu_torch.ops.pallas_scan import DenseAcEngine, _zero_inert
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

    # B13 is B6's wrapper with the comb16 step: its errors are kept apart.
    max_err = {**{w.__name__: 0 for w in K.WRAPPERS}, "matchbits_comb16": 0}

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
        """B3 (dense), B4 + B7 (bitap) or B10 + B14 (comb16), and B6 or B13,
        against their plain versions on the same staged streams."""
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
        ("comb16_count", "config 2, 100 needles", c2),
        ("comb16_count", "nested, 4 count ranges", ["a", "aa", "aaa", "aaaa", "aaaaa"]
         + random_needles(13, 80)),
        ("comb16_count", "150 needles", random_needles(21, 150)),
        ("comb16_count", "97 needles, no short one", n97),
        ("comb16_count", "NUL needles, no screen", c2[:60] + ["a\x00b", "\x00\x00x"]),
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
        if label.startswith("nested"):
            check(len(eng.c16.count_ranges) == 4, "nested case has no 4 count ranges")
        if name == "comb16_count":
            check(("NUL" in label) == (eng._filter_tables is None), f"{label}: screen planned wrong")
        st = eng.stage(data)
        total = compare(name, eng, st, label)
        ref = CppAcEngine(m).count(data)
        check(total == ref, f"{name} {label}: kernel {total} != host C++ {ref}")
        step = check_sticky_and_bits(eng, st, label)
        any_, n_present, n_matches = check_answers(eng, st, m, data, label)
        print(f"check {name:12s} {label:30s} {extra:26s} count={total} host_cpp={ref} "
              f"contains={any_} present={n_present}/{len(m.values)} matches={n_matches} "
              f"bits_step={step} ok")

    def zero_counts():
        for w in K.WRAPPERS:
            w.launches = 0

    def read_counts():
        return {w.__name__: w.launches for w in K.WRAPPERS}

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
        "contains_all true": {"matchbits"},
        "contains_all false": {"matchbits"},
        "all_matches_arrays": {"matchbits"},
    }
    for op, who, used in run_ops(ops2, want2):
        if who == "main path":
            check(set(used) == expect[op], f"{op}: launched {used}, expected {expect[op]}")
            tally(c16_main, used)
        else:
            check(set(used) == {"comb16_contains"}, f"{op} ({who}): launched {used}")
            tally(c16_control, used)
    for name in ("comb16_count", "comb16_contains", "matchbits", "filter_contains"):
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
        (from the hit bitmap), else its ``vend``."""
        _, bits = K.matchbits(*bits_eng.bits_args(sst))
        w = bits.long() & 0xFFFFFFFF  # [T/32, S]
        nz = w != 0
        word = torch.argmax(nz.int(), dim=0)  # first non-zero word (0 when none)
        low = w.gather(0, word.unsqueeze(0)).squeeze(0)
        bit = torch.log2((low & -low).double().clamp(min=1)).long()
        t = word * 32 + bit
        vend = sst.vend.long()
        return torch.where(nz.any(0) & (t < vend), t + 1, vend).clamp(max=sst.plan.time_len)

    def bound(stream_bytes, other_bytes, ops):
        """(least ms, what bounds it): each input byte read once and each
        output byte written once at the HBM rate, against ``ops`` 32-bit
        operations at the ALU rate."""
        b = (stream_bytes + other_bytes) / HBM_BYTES_PER_S * 1e3
        o = ops / ALU_OPS_PER_S * 1e3
        return (b, "bytes") if b >= o else (o, "operations")

    def table_bytes(args):
        return sum(a.numel() * a.element_size() for a in args[1:] if torch.is_tensor(a))

    def n_live_bytes(sst):
        return int(sst.vend.clamp(max=sst.plan.time_len).long().sum())

    miss_eng = miss_dense._engine.device_engine()
    st_c2, st_digits = st2["config 2"].device, st2["digits (2b)"].device
    S = st.plan.n_streams
    T = st.plan.time_len
    need_bench = int(first_hit_steps(bitap_eng, st).sum())
    need_digits = int(first_hit_steps(eng2, st_digits).sum())
    need_c2 = int(first_hit_steps(eng2, st_c2).sum())
    T2 = st_c2.plan.time_len
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
    for label, eng, sst, n in (("bench", bitap_eng, st, got), ("config 2", eng2, st_c2, got2)):
        t0 = time.perf_counter()
        for _ in range(3):
            eng.matches_arrays_staged(sst)
        extract_ms = (time.perf_counter() - t0) * 1e3 / 3
        print(f"time all_matches_arrays staged, {label} (B6 + compaction + host expansion of "
              f"{n} matches) {extract_ms:.3f} ms host clock ({card})")

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
    }
    # Launches from the main paths (the comb16 path's B6 launches ran the
    # comb16 step: they are B13's), and apart from them the controls'.
    launches = tally(tally({}, bench_main), dense_main)
    launches.update({n: c16_main.get(n, 0) for n in ("comb16_count", "comb16_contains",
                                                      "filter_contains")})
    launches["matchbits_comb16"] = c16_main.get("matchbits", 0)
    control = tally({}, bench_control)
    control.update({n: c16_control.get(n, 0) for n in ("comb16_count", "comb16_contains",
                                                        "filter_contains")})
    control["matchbits_comb16"] = c16_control.get("matchbits", 0)
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
        kernels.append(entry)

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": gpu, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
