"""Time the port's segmented scans against the same kernels built from another
source tree, in turns, on one CUDA card.

    python3 kernel_turns.py PARENT_DIR [--runs N] [--grid] [--walls]

``PARENT_DIR`` holds an earlier checkout's ``alfred_margaret_tpu_torch/csrc``
(for example ``git archive <commit> alfred_margaret_tpu_torch/csrc | tar -x
-C PARENT_DIR``, in a directory ``.gitignore`` lists).  Its sources are
built with the port's ``nvcc`` flags and called through the launchers of the
tree before B6 and B13 took segments (their signatures are bound below).
At the main paths' shapes (128 MiB, S = 32768, T = 4224; the mesh's shards
of (4,2,1) at 4096 streams and of (2,1,4) at 16384), each kernel runs in
turns, parent, this tree, this tree, parent, ``--runs`` launches a timing
(CUDA events), and each pair's outputs must be equal:

* B6, the hit bitmap: the bench needles' one-word bitap step and their dense
  step, and site S8, the dense step on shard 0 of the (4,2,1) mesh;
* B13, B6's comb16 step: config 2's 100 needles;
* B9, B11 (both modes, the one-group mode as site S4; the grouped mode on a
  corpus it scans in full and on one where it stops at the first match),
  B15, B17 and S5 (B9 with one group), which must not move.

With ``--grid`` it also times this tree's B6 (both steps), S8 and B13 at
other segment counts than their rule picks; with ``--walls`` the operations that launch B6 and B13 (``all_matches_arrays``
on the bench needles and on config 2), host clock until the answer is on the
host, with the parent's launcher swapped in for this tree's, in turns.
Prints each timing, the card's name and power limit, and one JSON line.
Needs one CUDA card and ``nvcc``; the parent's library goes to
``alfred_margaret_tpu_torch/_build/parent``.
"""

from __future__ import annotations

import argparse
import ctypes
import glob
import json
import os
import sys
import time
from unittest import mock

import numpy as np

import chip_smoke as smoke


def _bind_parent(lib) -> None:
    """The launchers of the parent tree this script calls."""
    p, i = ctypes.c_void_p, ctypes.c_int
    grouped = [i, p, p, i, p, i, p, p, p]  # G, classmap, comb, cw, aux, aw, root_row, segtable, gscal
    lib.amt_comb16_count_grouped.restype = i
    lib.amt_comb16_count_grouped.argtypes = [p, i, i, p, p, *grouped, i, i, i, i, i, i, i, p, p]
    lib.amt_comb16_contains_grouped.restype = i
    lib.amt_comb16_contains_grouped.argtypes = [p, i, i, p, *grouped, i, i, i, i, i, p, p]
    lib.amt_comb16_contains_base.restype = i
    lib.amt_comb16_contains_base.argtypes = [p, i, i, p, *grouped[1:], i, i, i, i, p, p]
    comb = [p, p, i, p, i, i, i, i, i]  # classmap, comb, cw, def, dw, k, owner_bits, root
    lib.amt_comb_count.restype = i
    lib.amt_comb_count.argtypes = [p, i, i, p, p, *comb, i, i, p, p]
    lib.amt_comb_states.restype = i
    lib.amt_comb_states.argtypes = [p, i, i, *comb, i, i, p, p]
    # B6 and B13 before segments: one thread a whole stream, counts written.
    lib.amt_matchbits_dense.restype = i
    lib.amt_matchbits_dense.argtypes = [p, i, i, p, p, p, p, i, i, i, p, p, p]
    lib.amt_matchbits_bitap.restype = i
    lib.amt_matchbits_bitap.argtypes = [p, i, i, p, p, p, p, p, p, p, i, p, p, p]
    lib.amt_matchbits_comb16.restype = i
    lib.amt_matchbits_comb16.argtypes = [p, i, i, p, p, p, p, i, p, i, p, p, p, i, i, i, i,
                                         p, p, p]


def build_parent(src_dir: str, out_dir: str):
    """Build the ``csrc/*.cu`` under ``src_dir`` with the port's flags into
    ``out_dir``; returns (the bound library, seconds)."""
    from alfred_margaret_tpu_torch.kernels import build
    from alfred_margaret_tpu_torch.utils.device import nvcc_path

    srcs = sorted(glob.glob(os.path.join(src_dir, "alfred_margaret_tpu_torch", "csrc", "*.cu")))
    if not srcs:
        raise SystemExit(f"no csrc/*.cu under {src_dir}")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, "libparent.so")
    t0 = time.perf_counter()
    build._compile(nvcc_path(), srcs, so)
    lib = ctypes.CDLL(so)
    _bind_parent(lib)
    return lib, time.perf_counter() - t0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_turns: needs a CUDA card", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("parent")
    ap.add_argument("--runs", type=int, default=30)
    ap.add_argument("--walls", action="store_true",
                    help="also time the operations that launch B6 and B13 (host clock until "
                         "the answer is on the host) with the parent's launcher swapped in and "
                         "with this tree's, in turns")
    ap.add_argument("--grid", action="store_true",
                    help="also time this tree's B6, S8 and B13 at other segment counts than "
                         "their rule picks")
    a = ap.parse_args()

    from alfred_margaret_tpu_torch import CASE_SENSITIVE, Searcher
    from alfred_margaret_tpu_torch import kernels as K
    from alfred_margaret_tpu_torch.bench.dataformat import synth_corpus
    from alfred_margaret_tpu_torch.kernels import build
    from alfred_margaret_tpu_torch.kernels.comb import comb_count_design
    from alfred_margaret_tpu_torch.kernels.comb16_grouped import comb16_grouped_design
    from alfred_margaret_tpu_torch.kernels.matchbits import matchbits_design
    from alfred_margaret_tpu_torch.parallel import make_mesh
    from alfred_margaret_tpu_torch.utils.device import nvidia_smi_line

    dev = torch.device("cuda", 0)
    card = nvidia_smi_line()
    t0 = time.perf_counter()
    new = build.load()
    plib, parent_s = build_parent(a.parent, os.path.join(os.path.dirname(new.path), "parent"))
    print(f"built this tree and the parent in {time.perf_counter() - t0:.1f} s", flush=True)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(a.runs):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / a.runs

    # -- the main paths' inputs ---------------------------------------------------------
    B = smoke.CORPUS_BYTES
    digits = (smoke.DIGITS * (B // len(smoke.DIGITS) + 1))[:B]
    sb = Searcher.build(CASE_SENSITIVE, smoke.NEEDLES)
    bitap_eng = sb._engine.device_engine()
    with mock.patch.dict(os.environ, {"AMT_BITAP": "0"}):
        dense_eng = Searcher(CASE_SENSITIVE, sb.needles, machine=sb.automaton,
                             device="cuda")._engine.device_engine()
    datab = np.frombuffer(synth_corpus(smoke.NEEDLES, B, hit_fraction=0.01, seed=3), np.uint8)
    stgb = sb.stage(datab)
    stb = stgb.device
    eb = sb.distributed(make_mesh([dev] * 8, data=4, seq=2))
    sbm = eb.stage(datab)
    n1000 = smoke.config5_needles(1000)
    s1000 = Searcher.build(CASE_SENSITIVE, n1000)
    eng5 = s1000._engine.device_engine()
    data5 = np.frombuffer(synth_corpus(n1000[:500], B, hit_fraction=0.01, seed=11), np.uint8)
    st5c = s1000.stage(data5).device
    st5d = s1000.stage(np.frombuffer(digits, np.uint8)).device
    n300 = smoke.config5_needles(300)
    s300 = Searcher.build(CASE_SENSITIVE, n300)
    eng3 = s300._engine.device_engine()
    st3c = s300.stage(np.frombuffer(
        synth_corpus(n300, B, hit_fraction=0.01, seed=13), np.uint8)).device
    c2 = smoke.config2_needles()
    s100 = Searcher.build(CASE_SENSITIVE, c2)
    eng2 = s100._engine.device_engine()
    ec2 = s100.distributed(make_mesh([dev] * 8, data=2, seq=1, needle=4))
    data2 = np.frombuffer(synth_corpus(c2, B, hit_fraction=0.01, seed=5), np.uint8)
    stg2 = s100.stage(data2)
    st2 = stg2.device
    sc2 = ec2.stage(data2)
    sff = ec2.stage(np.frombuffer(smoke.fire_free(B, seed=1), np.uint8))
    i0, g0, d0 = ec2.shards()[0]
    _, s4_args, _ = ec2.shard_call("sticky", sff, i0, g0, d0)
    _, s5_args, _ = ec2.shard_call("count", sc2, i0, g0, d0)
    ib, gb, db = eb.shards()[0]
    _, s8_args, s8_kw = eb.shard_call("bits", sbm, ib, gb, db)
    torch.cuda.synchronize()

    # -- the parent's launches --------------------------------------------------------
    def ptr(x):
        return x.data_ptr()

    def parent_grouped_contains(streams, vend, t, overlap=None):
        d = comb16_grouped_design(streams, t, overlap)
        out = torch.zeros(streams.shape[1], dtype=torch.int32, device=dev)
        build.check(plib.amt_comb16_contains_grouped(
            ptr(streams), *streams.shape, ptr(vend), t.n_groups, ptr(t.classmap), ptr(t.comb),
            t.comb.shape[1], ptr(t.aux), t.aux.shape[1], ptr(t.root_row), ptr(t.segtable),
            ptr(t.gscal), t.BB, t.owner_mask, overlap or 0, d.segments, d.chunk, ptr(out),
            stream()))
        return out

    def parent_base(streams, vend, t, overlap=None):
        d = comb16_grouped_design(streams, t, overlap)
        out = torch.empty(streams.shape[1], dtype=torch.int32, device=dev)
        build.check(plib.amt_comb16_contains_base(
            ptr(streams), *streams.shape, ptr(vend), ptr(t.classmap), ptr(t.comb),
            t.comb.shape[1], ptr(t.aux), t.aux.shape[1], ptr(t.root_row), ptr(t.segtable),
            ptr(t.gscal), t.BB, t.owner_mask, overlap or 0, d.segments, ptr(out), stream()))
        return out

    def parent_count_grouped(streams, warm, vend, t, overlap=None):
        d = comb16_grouped_design(streams, t, overlap)
        out = torch.zeros(streams.shape[1], dtype=torch.int32, device=dev)
        build.check(plib.amt_comb16_count_grouped(
            ptr(streams), *streams.shape, ptr(warm), ptr(vend), t.n_groups, ptr(t.classmap),
            ptr(t.comb), t.comb.shape[1], ptr(t.aux), t.aux.shape[1], ptr(t.root_row),
            ptr(t.segtable), ptr(t.gscal), t.gscal.shape[1], t.BB, t.owner_mask, t.CB,
            overlap or 0, d.segments, d.chunk, ptr(out), stream()))
        return out

    def comb_ints(cm, comb, deft, k, ob, rb, rd):
        return (ptr(cm), ptr(comb), comb.numel(), ptr(deft), deft.numel(), k, ob, rb, rd)

    def parent_comb_count(streams, warm, vend, cm, comb, deft, k, ob, rb, rd, overlap=None):
        d = comb_count_design(streams, comb, deft, overlap)
        out = torch.zeros(streams.shape[1], dtype=torch.int32, device=dev)
        build.check(plib.amt_comb_count(
            ptr(streams), *streams.shape, ptr(warm), ptr(vend),
            *comb_ints(cm, comb, deft, k, ob, rb, rd), overlap or 0, d.segments, ptr(out),
            stream()))
        return out

    def parent_states(streams, cm, comb, deft, k, ob, rb, rd, overlap=None):
        d = comb_count_design(streams, comb, deft, overlap)
        out = torch.empty(*streams.shape, dtype=torch.int32, device=dev)
        build.check(plib.amt_comb_states(
            ptr(streams), *streams.shape, *comb_ints(cm, comb, deft, k, ob, rb, rd),
            overlap or 0, d.segments, ptr(out), stream()))
        return out

    def parent_bits(streams, warm, vend, step, *tables, overlap=None):
        """The parent's B6 / B13: one thread a whole stream (no overlap)."""
        T, S = streams.shape
        counts = torch.empty(S, dtype=torch.int32, device=dev)
        bits = torch.empty(T // 32, S, dtype=torch.int32, device=dev)
        head = (ptr(streams), T, S, ptr(warm), ptr(vend))
        outs = (ptr(counts), ptr(bits), stream())
        if step == "dense":
            cm, tab, packing, sb_ = tables
            err = plib.amt_matchbits_dense(*head, ptr(cm), ptr(tab), tab.numel(), packing, sb_,
                                           *outs)
        elif step == "bitap":
            bt, seed, em, _, fb, fw = tables
            err = plib.amt_matchbits_bitap(*head, ptr(bt), ptr(seed), ptr(em), ptr(fb), ptr(fw),
                                           fb.numel(), *outs)
        else:
            cm, comb, aux, rr, segt, rng, BB, om, CB, root = tables
            err = plib.amt_matchbits_comb16(*head, ptr(cm), ptr(comb), comb.numel(), ptr(aux),
                                            aux.numel(), ptr(rr), ptr(segt), ptr(rng), BB, om, CB,
                                            root, *outs)
        build.check(err)
        return counts, bits

    def bits_kernel(overlap):
        return lambda *args, **kw: K.matchbits(*args, overlap=overlap)

    def bits_design(args, overlap):
        return matchbits_design(args[0], *args[3:], overlap=overlap)

    y5, f5 = eng5._fused_sticky_setup().tables, eng5._fused_setup().tables
    ob, o2, o8 = stb.plan.overlap, st2.plan.overlap, s8_kw["overlap"]
    bitap_args, dense_args, c16_args = (bitap_eng.bits_args(stb), dense_eng.bits_args(stb),
                                        eng2.bits_args(st2))
    rows = [
        ("B6", "bench needles, bitap step", bits_kernel(ob), parent_bits, bitap_args,
         bits_design(bitap_args, ob)),
        ("B6", "bench needles, dense step", bits_kernel(ob), parent_bits, dense_args,
         bits_design(dense_args, ob)),
        ("S8", "B6 dense step, bench needles, (4,2,1) shard 0", bits_kernel(o8), parent_bits,
         s8_args, bits_design(s8_args, o8)),
        ("B13", "config 2, comb16 step", bits_kernel(o2), parent_bits, c16_args,
         bits_design(c16_args, o2)),
        ("B11", "config 5, digits corpus: full scan", K.comb16_contains_grouped,
         parent_grouped_contains, eng5.sticky_args(st5d),
         comb16_grouped_design(st5d.streams, y5, st5d.plan.overlap)),
        ("B11", "config 5 corpus: stops at the first match", K.comb16_contains_grouped,
         parent_grouped_contains, eng5.sticky_args(st5c),
         comb16_grouped_design(st5c.streams, y5, st5c.plan.overlap)),
        ("S4", "B11 one-group, config 2 group 0, fire-free shard 0", K.comb16_contains_base,
         parent_base, s4_args, comb16_grouped_design(s4_args[0], s4_args[2], s4_args[3])),
        ("B17", "config 5, 300 needles", K.comb_states, parent_states, eng3.states_args(st3c),
         comb_count_design(st3c.streams, eng3.full_tables.comb, eng3.full_tables.def_table,
                           st3c.plan.overlap)),
        ("B9", "config 5", K.comb16_count_grouped, parent_count_grouped, eng5._count_args(st5c),
         comb16_grouped_design(st5c.streams, f5, st5c.plan.overlap)),
        ("B15", "config 5, 300 needles", K.comb_count, parent_comb_count,
         eng3._kernel_args(st3c), comb_count_design(st3c.streams, eng3.tables.comb,
                                                    eng3.tables.def_table, st3c.plan.overlap)),
        ("S5", "B9 one group, config 2 group 0, shard 0", K.comb16_count_grouped,
         parent_count_grouped, s5_args, comb16_grouped_design(s5_args[0], s5_args[3],
                                                              s5_args[4])),
    ]

    def same(got, ref):
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        torch.cuda.synchronize()
        return max((int((g.long() - r.long()).abs().max()) if g.numel() else 0)
                   for g, r in zip(got, ref))

    out = []
    for tag, what, kernel, parent, args, design in rows:
        err = same(kernel(*args), parent(*args))
        if err:
            raise SystemExit(f"{tag} {what}: this tree != parent (max err {err})")
        turns = [(lbl, timed(lambda: fn(*args))) for lbl, fn in (
            ("parent", parent), ("new", kernel), ("new", kernel), ("parent", parent))]
        p_ms = [ms for lbl, ms in turns if lbl == "parent"]
        n_ms = [ms for lbl, ms in turns if lbl == "new"]
        print(f"turns {tag:4s} {what:55s} parent {p_ms[0]:.4f} / {p_ms[1]:.4f} ms, new "
              f"{n_ms[0]:.4f} / {n_ms[1]:.4f} ms ({design.as_dict()}; {card})", flush=True)
        out.append({"kernel": tag, "what": what, "parent_ms": p_ms, "new_ms": n_ms,
                    "design": design.as_dict(), "max_abs_err": err})
    grid = []
    if a.grid:
        def bits_at(args, overlap, k):
            """This tree's launcher of ``args``' step at ``k`` segments."""
            streams, warm, vend, step, *tables = args
            T, S = streams.shape
            counts = torch.zeros(S, dtype=torch.int32, device=dev)
            bits = torch.empty(T // 32, S, dtype=torch.int32, device=dev)
            head = (ptr(streams), T, S, ptr(warm), ptr(vend))
            tail = (overlap, k, ptr(counts), ptr(bits), stream())
            if step == "dense":
                cm, tab, packing, sb_ = tables
                err = new.lib.amt_matchbits_dense(*head, ptr(cm), ptr(tab), tab.numel(), packing,
                                                  sb_, *tail)
            elif step == "bitap":
                bt, seed, em, _, fb, fw = tables
                err = new.lib.amt_matchbits_bitap(
                    *head, ptr(bt), ptr(seed), ptr(em), ptr(fb), ptr(fw), fb.numel(), *tail)
            else:
                cm, comb, aux, rr, segt, rng, BB, om, CB, root = tables
                err = new.lib.amt_matchbits_comb16(
                    *head, ptr(cm), ptr(comb), comb.numel(), ptr(aux), aux.numel(), ptr(rr),
                    ptr(segt), ptr(rng), BB, om, CB, root, *tail)
            build.check(err)
            return counts, bits

        for tag, args, over in (("B6 bitap", bitap_args, ob), ("B6 dense", dense_args, ob),
                                ("S8", s8_args, o8), ("B13", c16_args, o2)):
            ref = K.matchbits(*args, overlap=over)
            for k in (1, 4, 8, 16, 32, 64):
                if same(bits_at(args, over, k), ref):
                    raise SystemExit(f"{tag} k={k}: != the rule's launch")
                ms = timed(lambda: bits_at(args, over, k))
                grid.append({"kernel": tag, "k": k, "ms": ms})
                print(f"grid {tag:8s} k={k:2d} {ms:.4f} ms ({card})", flush=True)
    walls = []
    if a.walls:
        from alfred_margaret_tpu_torch.ops import pallas_scan as ops_dense

        def wall_ms(fn, n=9):
            fn()
            times = []
            for _ in range(n):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            return float(np.median(times))

        for tag, what, fn in (
                ("B6", "bench needles all_matches_arrays (bitap step)",
                 lambda: sb.all_matches_arrays(stgb)),
                ("B13", "config 2 all_matches_arrays (comb16 step)",
                 lambda: s100.all_matches_arrays(stg2))):
            got = fn()
            with mock.patch.object(ops_dense, "matchbits", parent_bits):
                ref = fn()
            if not all(np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(got, ref)):
                raise SystemExit(f"{tag} {what}: answers differ with the parent's launcher")
            turns = []
            for lbl in ("parent", "new", "new", "parent"):
                if lbl == "parent":
                    with mock.patch.object(ops_dense, "matchbits", parent_bits):
                        turns.append((lbl, wall_ms(fn)))
                else:
                    turns.append((lbl, wall_ms(fn)))
            p_ms = [ms for lbl, ms in turns if lbl == "parent"]
            n_ms = [ms for lbl, ms in turns if lbl == "new"]
            print(f"wall  {tag:4s} {what:60s} parent {p_ms[0]:.3f} / {p_ms[1]:.3f} ms, new "
                  f"{n_ms[0]:.3f} / {n_ms[1]:.3f} ms (median of 9, host clock; {card})",
                  flush=True)
            walls.append({"kernel": tag, "what": what, "parent_ms": p_ms, "new_ms": n_ms})
    line = json.dumps({"turns": out, "grid": grid, "walls": walls, "card": card,
                       "runs": a.runs, "parent_build_s": parent_s})
    print(card)
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
