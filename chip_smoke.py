"""Drive the PyTorch port's count-all-matches path once on one NVIDIA GPU.

Run from the repository root on a host with one CUDA card (an H100):

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``alfred_margaret_tpu_torch/csrc``,
checks each kernel against its plain torch version on the card, runs the main
path (``Searcher.build`` -> ``stage`` -> ``count_matches``) over the
benchmark's 128 MiB corpus with the benchmark's needles, checks the count
against the host C++ engine and the dense-kernel control, and times both
kernels and both plain versions with CUDA events.  Any failure raises and
the exit code is non-zero.  Without a CUDA device it exits non-zero before
printing a result.

The last two lines of standard output are the kernels' JSON summary and the
card's ``nvidia-smi`` name and power limit; the very last line is
``{"ok": true, "device": {...}}``.
"""

import json
import os
import sys
import time

import numpy as np

#: The benchmark's configuration (``bench.py``): needles, corpus, seed.
NEEDLES = ["tshirt", "shirts", "shorts"]
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
    from alfred_margaret_tpu_torch import CASE_SENSITIVE, Searcher, toolchain_report
    from alfred_margaret_tpu_torch.kernels import bitap_count, build, dense_count
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
        if "Used" in line or ("spill" in line and " 0 bytes spill stores" not in line):
            print("  ptxas:", line.split(":", 1)[-1].strip())

    from alfred_margaret_tpu.native import build as native_build
    from alfred_margaret_tpu.native.cpp_engine import CppAcEngine

    try:
        native_build.load()
        host_count = lambda machine, data: CppAcEngine(machine).count(data)  # noqa: E731
    except native_build.NativeUnavailable as e:
        print(f"host C++ engine unavailable ({e}); counts are checked against "
              "the plain torch versions on the card only")
        host_count = None

    max_err = {"bitap_count": 0, "dense_count": 0}

    def compare(name, eng, st, label):
        """Kernel vs plain version on the same staged streams: per live
        stream and in total.  Returns the kernel's total."""
        k = eng.stream_counts(st)
        torch.cuda.synchronize()
        p = eng.stream_counts_plain(st)
        torch.cuda.synchronize()
        live = torch.from_numpy(st.live_np).to(dev)
        err = int((k[live].long() - p[live].long()).abs().max()) if bool(live.any()) else 0
        max_err[name] = max(max_err[name], err)
        kt, pt = int(k[live].long().sum()), int(p[live].long().sum())
        check(err == 0 and kt == pt, f"{name} {label}: kernel {kt} != plain {pt} (max err {err})")
        return kt

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
        ref = host_count(m, data) if host_count else None
        if ref is not None:
            check(total == ref, f"{name} {label}: kernel {total} != host C++ {ref}")
        print(f"check {name:12s} {label:30s} {extra:26s} count={total} host_cpp={ref} ok")

    # -- the main path at the benchmark's size ------------------------------
    data = np.frombuffer(
        synth_corpus(NEEDLES, CORPUS_BYTES, hit_fraction=0.01, seed=3), np.uint8
    )
    searcher = Searcher.build(CASE_SENSITIVE, NEEDLES, device="cuda")
    dense_searcher = Searcher(
        CASE_SENSITIVE, searcher.needles, machine=searcher.automaton, device="cuda"
    )
    bitap_count.launches = 0
    dense_count.launches = 0
    t0 = time.perf_counter()
    staged = searcher.stage(data)
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = searcher.count_matches(staged)
    count_s = time.perf_counter() - t0
    prior = os.environ.get("AMT_BITAP")
    os.environ["AMT_BITAP"] = "0"  # the paired dense control, on the same staging
    try:
        got_dense = dense_searcher.count_matches(staged)
    finally:
        if prior is None:
            os.environ.pop("AMT_BITAP")
        else:
            os.environ["AMT_BITAP"] = prior
    launches = {"bitap_count": bitap_count.launches, "dense_count": dense_count.launches}
    bitap_eng = searcher._engine.device_engine()
    dense_eng = dense_searcher._engine.device_engine()
    check(isinstance(bitap_eng, BitapAcEngine), f"main path took {type(bitap_eng).__name__}")
    check(type(dense_eng) is DenseAcEngine, f"control took {type(dense_eng).__name__}")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched by the main path")
    st = staged.device
    print(f"main path: {CORPUS_BYTES} bytes, {st.plan}, stage {stage_s:.3f} s, "
          f"count_matches {count_s:.3f} s, launches {launches}")
    if host_count is not None:
        ref, ref_name = host_count(searcher.automaton, data), "host C++ engine"
    else:
        ref, ref_name = compare("bitap_count", bitap_eng, st, "main path"), "plain torch version"
        print("main path reference: the plain torch version on the card "
              "(host C++ engine unavailable)")
    check(got == ref, f"main path count {got} != {ref_name} {ref}")
    check(got_dense == got, f"dense control {got_dense} != bitap {got}")
    check(got > 0, "main path counted no match")
    print(f"main path count {got} == {ref_name} {ref} == dense control {got_dense}")

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

    kernels = []
    for name, eng, source, replaces in (
        ("bitap_count", bitap_eng, "alfred_margaret_tpu_torch/csrc/bitap_count.cu",
         "alfred_margaret_tpu/ops/bitap_scan.py:352"),
        ("dense_count", dense_eng, "alfred_margaret_tpu_torch/csrc/dense_count.cu",
         "alfred_margaret_tpu/ops/pallas_scan.py:281"),
    ):
        compare(name, eng, st, "main path shape")
        ms = timed(lambda: eng.stream_counts(st), KERNEL_RUNS)
        plain_ms = timed(lambda: eng.stream_counts_plain(st), PLAIN_RUNS)
        for what, t in (("kernel", ms), ("plain", plain_ms)):
            print(f"time {name:12s} {what:6s} {t:10.3f} ms  {CORPUS_BYTES / t / 1e6:9.2f} GB/s "
                  f"(T={st.plan.time_len} S={st.plan.n_streams}; {card})")
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": max_err[name],
            "ms": ms, "plain_ms": plain_ms,
        })

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": gpu, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
