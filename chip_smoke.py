"""Drive the PyTorch port's Searcher once on one NVIDIA GPU.

Run from the repository root on a host with one CUDA card (an H100):

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``alfred_margaret_tpu_torch/csrc``
(one ``nvcc`` per source, all at once), checks each of the six kernels
against its plain torch version on the card on seven machines, and the
engines' answers against the host C++ engine.  Then it drives the main paths
over the benchmark's 128 MiB corpus with the benchmark's needles: ``stage``
-> ``count_matches`` (kernels B2, and B1 as the dense control), then
``contains_any`` on a hit and a miss (B4; B3 in four segments as the dense
control), ``contains_all`` true and false (B7; B6 as the dense control) and
``all_matches_arrays`` (B6 with its bitap and its dense step).  Every answer
must equal the host C++ engine's and the dense control's, and every kernel
of a path must have been launched by it.  Last it times every kernel and its
plain version with CUDA events.  Any failure raises and the exit code is
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


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; needs one CUDA card",
              file=sys.stderr)
        return 1

    from alfred_margaret_tpu.bench.dataformat import synth_corpus
    from alfred_margaret_tpu.models import ac
    from alfred_margaret_tpu.native import build as native_build
    from alfred_margaret_tpu_torch import CASE_SENSITIVE, Searcher, toolchain_report
    from alfred_margaret_tpu_torch import kernels as K
    from alfred_margaret_tpu_torch.engine import CppAcEngine
    from alfred_margaret_tpu_torch.kernels import build
    from alfred_margaret_tpu_torch.ops.bitap_scan import BitapAcEngine, plan_bitap
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

    max_err = {w.__name__: 0 for w in K.WRAPPERS}

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
        """B1/B2 vs plain on the same staged streams.  Returns the kernel's
        total over live streams."""
        k = eng.stream_counts(st)
        same(name, k, eng.stream_counts_plain(st), label)
        return int(k[torch.from_numpy(st.live_np).to(dev)].long().sum())

    def check_sticky_and_bits(eng, st, label):
        """B3 (dense) or B4 + B7 (bitap), and B6, against their plain
        versions on the same staged streams."""
        if isinstance(eng, BitapAcEngine):
            args = eng.sticky_bitap_args(st)
            same("bitap_contains", K.bitap_contains(*args), K.bitap_contains_plain(*args), label)
            same("bitap_presence", K.bitap_presence(*args), K.bitap_presence_plain(*args), label)
        else:
            args = eng.sticky_args(st)
            whole = K.dense_contains(*args)
            same("dense_contains", whole, K.dense_contains_plain(*args), label)
            S = st.plan.n_streams
            parts = [K.dense_contains(*eng.sticky_args(st, k * S // 4, (k + 1) * S // 4))
                     for k in range(4)]
            same("dense_contains", torch.cat(parts), whole, label + ", K=4 segments")
        args = eng.bits_args(st)
        counts, bits = K.matchbits(*args)
        pcounts, pbits = K.matchbits_plain(*args)
        same("matchbits", counts, pcounts, label + " counts")
        same("matchbits", bits, pbits, label + " bitmap")
        return args[3]

    def check_answers(eng, st, m, data, label):
        """The engine's answers against the host C++ engine's."""
        host = CppAcEngine(m)
        any_ = eng.contains_staged(st)
        check(any_ == (host.first_hit(data) >= 0), f"{label}: contains != host C++")
        if isinstance(eng, DenseAcEngine) and not isinstance(eng, BitapAcEngine):
            check(eng.contains_staged_early(st, n_segments=4) == any_, f"{label}: early != whole")
            _, hit = eng.match_positions_staged(st)
            pres = ac.presence_of_states(m, hit, len(m.values))
        else:
            pres = eng.needle_presence_staged(st)
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
    cases = [
        ("bitap_count", "bench needles", NEEDLES),
        ("bitap_count", "overlap and suffix needles", ["ab", "b", "abc", "zz"]),
        ("bitap_count", "duplicate needles", ["x", "x", "yy", "x"]),
        ("bitap_count", "two words (V=2)", v2),
        ("dense_count", "bench needles, AMT_BITAP=0", NEEDLES),
        ("dense_count", "30 needles, packing 2", pk2),
        ("dense_count", "NUL needles, not zero-inert", ["a\x00b", "\x00\x00", "xyz"]),
    ]
    for seed, (name, label, needles) in enumerate(cases):
        m = machine_of(needles)
        data = np.frombuffer(
            synth_corpus(needles, CHECK_BYTES, hit_fraction=0.02, seed=seed), np.uint8
        )
        if name == "bitap_count":
            eng = BitapAcEngine(m, layout=plan_bitap(m, max_words=2), device=dev)
            extra = f"V={eng.bitap.n_words}"
        else:
            eng = DenseAcEngine(m, device=dev)
            extra = f"packing={eng.comp.packing} zero_inert={_zero_inert(m)}"
        if label.startswith("two words"):
            check(eng.bitap.n_words == 2, "V=2 case planned to another width")
        if "packing 2" in label:
            check(eng.comp.packing == 2, "packing-2 case planned to packing 1")
        if "NUL" in label:
            check(not _zero_inert(m), "NUL case is zero-inert")
        st = eng.stage(data)
        total = compare(name, eng, st, label)
        ref = CppAcEngine(m).count(data)
        check(total == ref, f"{name} {label}: kernel {total} != host C++ {ref}")
        step = check_sticky_and_bits(eng, st, label)
        any_, n_present, n_matches = check_answers(eng, st, m, data, label)
        print(f"check {name:12s} {label:30s} {extra:26s} count={total} host_cpp={ref} "
              f"contains={any_} present={n_present}/{len(m.values)} matches={n_matches} "
              f"bits_step={step} ok")

    # -- the count path at the benchmark's size -----------------------------
    data = np.frombuffer(
        synth_corpus(NEEDLES, CORPUS_BYTES, hit_fraction=0.01, seed=3), np.uint8
    )
    host = CppAcEngine(machine_of(NEEDLES))
    searcher = Searcher.build(CASE_SENSITIVE, NEEDLES, device="cuda")
    with mock.patch.dict(os.environ, {"AMT_BITAP": "0"}):  # dense controls
        dense_searcher = Searcher(
            CASE_SENSITIVE, searcher.needles, machine=searcher.automaton, device="cuda"
        )
        dense_eng = dense_searcher._engine.device_engine()
    bitap_eng = searcher._engine.device_engine()
    check(isinstance(bitap_eng, BitapAcEngine), f"main path took {type(bitap_eng).__name__}")
    check(type(dense_eng) is DenseAcEngine, f"control took {type(dense_eng).__name__}")

    def zero_counts():
        for w in K.WRAPPERS:
            w.launches = 0

    def read_counts():
        return {w.__name__: w.launches for w in K.WRAPPERS}

    zero_counts()
    t0 = time.perf_counter()
    staged = searcher.stage(data)
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = searcher.count_matches(staged)
    count_s = time.perf_counter() - t0
    got_dense = dense_searcher.count_matches(staged)
    count_launches = read_counts()
    for name in ("bitap_count", "dense_count"):
        check(count_launches[name] > 0, f"{name} was not launched by the count path")
    st = staged.device
    print(f"count path: {CORPUS_BYTES} bytes, {st.plan}, stage {stage_s:.3f} s, "
          f"count_matches {count_s:.3f} s, launches {count_launches}")
    ref = host.count(data)
    check(got == ref, f"main path count {got} != host C++ engine {ref}")
    check(got_dense == got, f"dense control {got_dense} != bitap {got}")
    check(got > 0, "main path counted no match")
    print(f"count path: count {got} == host C++ engine {ref} == dense control {got_dense}")

    # -- containsAny, containsAll and allMatches at the benchmark's size -----
    miss = Searcher.build(CASE_SENSITIVE, MISS_NEEDLES, device="cuda")
    absent = Searcher.build(CASE_SENSITIVE, NEEDLES + ["SHORTS"], device="cuda")
    with mock.patch.dict(os.environ, {"AMT_BITAP": "0"}):  # dense controls
        miss_dense = Searcher(CASE_SENSITIVE, miss.needles, machine=miss.automaton, device="cuda")
        absent_dense = Searcher(CASE_SENSITIVE, absent.needles, machine=absent.automaton,
                                device="cuda")
        for s in (miss_dense, absent_dense):
            check(type(s._engine.device_engine()) is DenseAcEngine, "control is not dense")
    staged_miss = miss.stage(data)
    staged_absent = absent.stage(data)
    torch.cuda.synchronize()
    host_ends, host_vids = host.matches_arrays(data)
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
    ops = [
        # (operation, control?, call)
        ("contains_any hit", False, lambda: searcher.contains_any(staged)),
        ("contains_any hit", True, lambda: dense_searcher.contains_any(staged)),
        ("contains_any miss", False, lambda: miss.contains_any(staged_miss)),
        ("contains_any miss", True, lambda: miss_dense.contains_any(staged_miss)),
        ("contains_all true", False, lambda: searcher.contains_all(staged)),
        ("contains_all true", True, lambda: dense_searcher.contains_all(staged)),
        ("contains_all false", False, lambda: absent.contains_all(staged_absent)),
        ("contains_all false", True, lambda: absent_dense.contains_all(staged_absent)),
        ("all_matches_arrays", False, lambda: searcher.all_matches_arrays(staged)),
        ("all_matches_arrays", True, lambda: dense_searcher.all_matches_arrays(staged)),
    ]
    zero_counts()
    walls = []
    for op, control, call in ops:
        before = read_counts()
        t0 = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = read_counts()
        used = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        who = "dense control" if control else "main path"
        if op == "all_matches_arrays":
            ends, vids = out
            check(np.array_equal(ends, host_ends) and np.array_equal(vids, host_vids),
                  f"{op} ({who}): {len(ends)} matches != host C++ {len(host_ends)}")
            check(len(ends) == got, f"{op} ({who}): {len(ends)} matches != count {got}")
            shown = f"{len(ends)} matches"
        else:
            check(out is want[op], f"{op} ({who}): {out} != host C++ {want[op]}")
            shown = str(out)
        if op == "contains_any hit" and control:
            check(used.get("dense_contains") == 4, f"dense contains_any ran {used} (not 4 segments)")
        walls.append((op, who, wall, shown, used))
        print(f"op {op:20s} {who:13s} {wall * 1e3:10.3f} ms wall  -> {shown:16s} "
              f"launches {used} ({card})")
    op_launches = read_counts()
    for name in ("dense_contains", "bitap_contains", "matchbits", "bitap_presence"):
        check(op_launches[name] > 0, f"{name} was not launched by the operations' main path")
    print(f"operations' main path: every answer == host C++ == dense control; "
          f"launches {op_launches}")

    # -- timing at the main path's shape -------------------------------------
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
        print(f"time {name:16s} {what:34s} {ms:10.3f} ms  {CORPUS_BYTES / ms / 1e6:9.2f} GB/s "
              f"({shape}; {card})")

    miss_eng = miss_dense._engine.device_engine()
    timings = {}
    for name, kernel, plain, args, what in (
        ("bitap_count", K.bitap_count, K.bitap_count_plain, bitap_eng._kernel_args(st),
         "bench needles"),
        ("dense_count", K.dense_count, K.dense_count_plain, dense_eng._kernel_args(st),
         "bench needles"),
        ("dense_contains", K.dense_contains, K.dense_contains_plain, dense_eng.sticky_args(st),
         "bench needles"),
        ("dense_contains", K.dense_contains, K.dense_contains_plain,
         miss_eng.sticky_args(staged_miss.device), "miss needles, full scan"),
        ("bitap_contains", K.bitap_contains, K.bitap_contains_plain,
         bitap_eng.sticky_bitap_args(st), "bench needles"),
        ("bitap_presence", K.bitap_presence, K.bitap_presence_plain,
         bitap_eng.sticky_bitap_args(st), "bench needles"),
        ("matchbits", K.matchbits, K.matchbits_plain, bitap_eng.bits_args(st),
         "bench needles, bitap step"),
        ("matchbits", K.matchbits, K.matchbits_plain, dense_eng.bits_args(st),
         "bench needles, dense step"),
    ):
        k, p = kernel(*args), plain(*args)
        for a, b in zip(k if isinstance(k, tuple) else (k,), p if isinstance(p, tuple) else (p,)):
            same(name, a, b, f"{what} at the main path's shape")
        ms = timed(lambda: kernel(*args), KERNEL_RUNS)
        plain_ms = timed(lambda: plain(*args), PLAIN_RUNS)
        report(name, f"kernel, {what}", ms)
        report(name, f"plain, {what}", plain_ms)
        timings[(name, what)] = (ms, plain_ms)

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
    t0 = time.perf_counter()
    for _ in range(3):
        bitap_eng.matches_arrays_staged(st)
    extract_ms = (time.perf_counter() - t0) * 1e3 / 3
    print(f"time all_matches_arrays staged (B6 + compaction + host expansion of {got} matches) "
          f"{extract_ms:.3f} ms host clock ({card})")

    # name: (source, TPU kernel it replaces, the timing of its main path)
    table = {
        "bitap_count": ("bitap_count.cu", "bitap_scan.py:352", "bench needles"),
        "dense_count": ("dense_count.cu", "pallas_scan.py:281", "bench needles"),
        "dense_contains": ("dense_contains.cu", "pallas_scan.py:426", "bench needles"),
        "bitap_contains": ("bitap_contains.cu", "bitap_scan.py:466", "bench needles"),
        "matchbits": ("matchbits.cu", "pallas_scan.py:1174", "bench needles, bitap step"),
        "bitap_presence": ("bitap_contains.cu", "bitap_scan.py:551", "bench needles"),
    }
    launches = {**op_launches, "bitap_count": count_launches["bitap_count"],
                "dense_count": count_launches["dense_count"]}
    kernels = []
    for name, (src, where, what) in table.items():
        ms, plain_ms = timings[(name, what)]
        entry = {
            "name": name, "route": "cuda", "source": f"alfred_margaret_tpu_torch/csrc/{src}",
            "replaces": f"alfred_margaret_tpu/ops/{where}", "launches": launches[name],
            "max_abs_err": max_err[name], "ms": ms, "plain_ms": plain_ms,
        }
        if name == "dense_contains":
            entry["ms_full_scan"], entry["plain_ms_full_scan"] = timings[
                (name, "miss needles, full scan")]
        if name == "matchbits":
            entry["ms_dense_step"], entry["plain_ms_dense_step"] = timings[
                (name, "bench needles, dense step")]
        kernels.append(entry)

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": gpu, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
