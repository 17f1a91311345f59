"""Time the port's segmented scans against the same kernels built from another
source tree, in turns, on one CUDA card.

    python3 kernel_turns.py PARENT_DIR [--runs N] [--grid] [--walls]

``PARENT_DIR`` holds an earlier checkout's ``alfred_margaret_tpu_torch/csrc``
(for example ``git archive <commit> alfred_margaret_tpu_torch/csrc | tar -x
-C PARENT_DIR``, in a directory ``.gitignore`` lists).  Its sources are
built with the port's ``nvcc`` flags and called through the launchers of the
tree before B11 and B17 took segments (their signatures are bound below).
At the main paths' shapes (128 MiB, S = 32768, T = 4224; the mesh's shards
of (2,1,4) at 16384 streams), each kernel runs in turns, parent, this tree,
this tree, parent, ``--runs`` launches a timing (CUDA events), and each
pair's outputs must be equal:

* B11, ``n_groups > 1``: config 5's first 1,000 needles' sticky groups on
  the digits corpus (full scan) and on the config-5 corpus;
* B11's one-group mode (site S4): config 2's needle group 0 on shard 0 of
  the fire-free corpus;
* B17: config 5's first 300 needles on the config-5 corpus;
* B9, B15 and S5 (B9 with one group), which must not move.

With ``--grid`` it also times this tree's B11, S4 and B17 at other segment
and chunk counts than their rules pick; with ``--walls`` the operations
that launch them (config 5's ``contains_any`` where the screen falls
through, the mesh's ``contains_any`` on (2,1,4), comb32 ``final_states``),
host clock until the answer is on the host, with the parent's launcher
swapped in for this tree's, in turns.  Prints each timing, the card's
name and power limit, and one JSON line.  Needs one CUDA card and
``nvcc``; the parent's library goes to ``alfred_margaret_tpu_torch/_build/parent``.
"""

from __future__ import annotations

import argparse
import ctypes
import glob
import json
import os
import sys
import time

import numpy as np

import chip_smoke as smoke


def _bind_parent(lib) -> None:
    """The launchers of the parent tree this script calls."""
    p, i = ctypes.c_void_p, ctypes.c_int
    grouped = [i, p, p, i, p, i, p, p, p]  # G, classmap, comb, cw, aux, aw, root_row, segtable, gscal
    lib.amt_comb16_count_grouped.restype = i
    lib.amt_comb16_count_grouped.argtypes = [p, i, i, p, p, *grouped, i, i, i, i, i, i, i, p, p]
    lib.amt_comb16_contains_grouped.restype = i
    lib.amt_comb16_contains_grouped.argtypes = [p, i, i, p, *grouped, i, i, p, p]
    lib.amt_comb16_contains_base.restype = i
    lib.amt_comb16_contains_base.argtypes = [p, i, i, p, *grouped[1:], i, i, p, p]
    comb = [p, p, i, p, i, i, i, i, i]  # classmap, comb, cw, def, dw, k, owner_bits, root
    lib.amt_comb_count.restype = i
    lib.amt_comb_count.argtypes = [p, i, i, p, p, *comb, i, i, p, p]
    lib.amt_comb_states.restype = i
    lib.amt_comb_states.argtypes = [p, i, i, *comb, p, p]


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
                    help="also time the operations that launch B11, S4 and B17 (host clock "
                         "until the answer is on the host) with the parent's launcher swapped "
                         "in and with this tree's, in turns")
    ap.add_argument("--grid", action="store_true",
                    help="also time this tree's B11, S4 and B17 at other segment and chunk "
                         "counts than their rules pick (the launchers take both)")
    a = ap.parse_args()

    from alfred_margaret_tpu_torch import CASE_SENSITIVE, Searcher
    from alfred_margaret_tpu_torch import kernels as K
    from alfred_margaret_tpu_torch.bench.dataformat import synth_corpus
    from alfred_margaret_tpu_torch.kernels import build
    from alfred_margaret_tpu_torch.kernels.comb import comb_count_design
    from alfred_margaret_tpu_torch.kernels.comb16_grouped import comb16_grouped_design
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
    ec2 = s100.distributed(make_mesh([dev] * 8, data=2, seq=1, needle=4))
    data2 = np.frombuffer(synth_corpus(c2, B, hit_fraction=0.01, seed=5), np.uint8)
    sc2 = ec2.stage(data2)
    sff = ec2.stage(np.frombuffer(smoke.fire_free(B, seed=1), np.uint8))
    i0, g0, d0 = ec2.shards()[0]
    _, s4_args = ec2.shard_call("sticky", sff, i0, g0, d0)
    _, s5_args = ec2.shard_call("count", sc2, i0, g0, d0)
    torch.cuda.synchronize()

    # -- the parent's launches --------------------------------------------------------
    def ptr(x):
        return x.data_ptr()

    def parent_grouped_contains(streams, vend, t, overlap=None):
        out = torch.zeros(streams.shape[1], dtype=torch.int32, device=dev)
        build.check(plib.amt_comb16_contains_grouped(
            ptr(streams), *streams.shape, ptr(vend), t.n_groups, ptr(t.classmap), ptr(t.comb),
            t.comb.shape[1], ptr(t.aux), t.aux.shape[1], ptr(t.root_row), ptr(t.segtable),
            ptr(t.gscal), t.BB, t.owner_mask, ptr(out), stream()))
        return out

    def parent_base(streams, vend, t, overlap=None):
        out = torch.empty(streams.shape[1], dtype=torch.int32, device=dev)
        build.check(plib.amt_comb16_contains_base(
            ptr(streams), *streams.shape, ptr(vend), ptr(t.classmap), ptr(t.comb),
            t.comb.shape[1], ptr(t.aux), t.aux.shape[1], ptr(t.root_row), ptr(t.segtable),
            ptr(t.gscal), t.BB, t.owner_mask, ptr(out), stream()))
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
        out = torch.empty(*streams.shape, dtype=torch.int32, device=dev)
        build.check(plib.amt_comb_states(
            ptr(streams), *streams.shape, *comb_ints(cm, comb, deft, k, ob, rb, rd), ptr(out),
            stream()))
        return out

    y5, f5 = eng5._fused_sticky_setup().tables, eng5._fused_setup().tables
    rows = [
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
    out = []
    for tag, what, kernel, parent, args, design in rows:
        got, ref = kernel(*args), parent(*args)
        torch.cuda.synchronize()
        err = int((got.long() - ref.long()).abs().max()) if got.numel() else 0
        if err:
            raise SystemExit(f"{tag} {what}: this tree != parent (max err {err})")
        turns = [(lbl, timed(lambda: fn(*args))) for lbl, fn in (
            ("parent", parent), ("new", kernel), ("new", kernel), ("parent", parent))]
        p_ms = [ms for lbl, ms in turns if lbl == "parent"]
        n_ms = [ms for lbl, ms in turns if lbl == "new"]
        print(f"turns {tag:10s} {what:55s} parent {p_ms[0]:.4f} / {p_ms[1]:.4f} ms, new "
              f"{n_ms[0]:.4f} / {n_ms[1]:.4f} ms ({design.as_dict()}; {card})", flush=True)
        out.append({"kernel": tag, "what": what, "parent_ms": p_ms, "new_ms": n_ms,
                    "design": design.as_dict(), "max_abs_err": err})
    grid = []
    if a.grid:
        def b11_at(args, k, gc):
            streams, vend, t, overlap = args
            o = torch.zeros(streams.shape[1], dtype=torch.int32, device=dev)
            build.check(new.lib.amt_comb16_contains_grouped(
                ptr(streams), *streams.shape, ptr(vend), t.n_groups, ptr(t.classmap),
                ptr(t.comb), t.comb.shape[1], ptr(t.aux), t.aux.shape[1], ptr(t.root_row),
                ptr(t.segtable), ptr(t.gscal), t.BB, t.owner_mask, overlap, k, gc, ptr(o),
                stream()))
            return o

        def s4_at(args, k, gc):
            streams, vend, t, overlap = args
            o = torch.empty(streams.shape[1], dtype=torch.int32, device=dev)
            build.check(new.lib.amt_comb16_contains_base(
                ptr(streams), *streams.shape, ptr(vend), ptr(t.classmap), ptr(t.comb),
                t.comb.shape[1], ptr(t.aux), t.aux.shape[1], ptr(t.root_row), ptr(t.segtable),
                ptr(t.gscal), t.BB, t.owner_mask, overlap, k, ptr(o), stream()))
            return o

        def b17_at(args, k, gc):
            streams, cm, comb, deft, kk, ob, rb, rd, overlap = args
            o = torch.empty(*streams.shape, dtype=torch.int32, device=dev)
            build.check(new.lib.amt_comb_states(
                ptr(streams), *streams.shape, *comb_ints(cm, comb, deft, kk, ob, rb, rd),
                overlap, k, ptr(o), stream()))
            return o

        b11_args, s4a, b17_args = eng5.sticky_args(st5d), s4_args, eng3.states_args(st3c)
        for tag, fn, args, ks, gcs, ref in (
                ("B11", b11_at, b11_args, (1, 2, 4, 8, 16), range(1, y5.n_groups + 1),
                 K.comb16_contains_grouped(*b11_args)),
                ("S4", s4_at, s4a, (1, 4, 8, 16, 32), (1,), K.comb16_contains_base(*s4a)),
                ("B17", b17_at, b17_args, (1, 4, 8, 16, 32), (1,), K.comb_states(*b17_args))):
            for k in ks:
                for gc in gcs:
                    if not torch.equal(fn(args, k, gc), ref):
                        raise SystemExit(f"{tag} k={k} Gc={gc}: != the rule's launch")
                    ms = timed(lambda: fn(args, k, gc))
                    grid.append({"kernel": tag, "k": k, "Gc": gc, "ms": ms})
                    print(f"grid {tag:4s} k={k:2d} Gc={gc} {ms:.4f} ms ({card})", flush=True)
    walls = []
    if a.walls:
        from unittest import mock

        from alfred_margaret_tpu_torch.ops import comb_scan as ops_comb
        from alfred_margaret_tpu_torch.ops import grouped as ops_grouped
        from alfred_margaret_tpu_torch.parallel import shard as par_shard

        stg5d = s1000.stage(np.frombuffer(digits, np.uint8))
        stg5c = s1000.stage(data5)
        st3_final = st3c

        def wall_ms(fn, n=9):
            fn()
            times = []
            for _ in range(n):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            return float(np.median(times))

        for tag, what, module, name, parent, fn in (
                ("B11", "config 5 contains_any, digits corpus (B14 then B11)", ops_grouped,
                 "comb16_contains_grouped", parent_grouped_contains,
                 lambda: s1000.contains_any(stg5d)),
                ("B11", "config 5 contains_any, config-5 corpus (B14 then B11)", ops_grouped,
                 "comb16_contains_grouped", parent_grouped_contains,
                 lambda: s1000.contains_any(stg5c)),
                ("S4", "mesh (2,1,4) contains_any, config 2, fire-free (8 x S4)", par_shard,
                 "comb16_contains_base", parent_base, lambda: ec2.contains_any(sff)),
                ("S4", "mesh (2,1,4) contains_any, config 2 corpus (8 x S4)", par_shard,
                 "comb16_contains_base", parent_base, lambda: ec2.contains_any(sc2)),
                ("B17", "comb32 final_states_staged, config 5's 300 (B17, 537 MB to the host)",
                 ops_comb, "comb_states", parent_states,
                 lambda: eng3.final_states_staged(st3_final))):
            got = fn()
            with mock.patch.object(module, name, parent):
                ref = fn()
            if not np.array_equal(np.asarray(got), np.asarray(ref)):
                raise SystemExit(f"{tag} {what}: answers differ with the parent's launcher")
            turns = []
            for lbl in ("parent", "new", "new", "parent"):
                if lbl == "parent":
                    with mock.patch.object(module, name, parent):
                        turns.append((lbl, wall_ms(fn)))
                else:
                    turns.append((lbl, wall_ms(fn)))
            p_ms = [ms for lbl, ms in turns if lbl == "parent"]
            n_ms = [ms for lbl, ms in turns if lbl == "new"]
            print(f"wall  {tag:4s} {what:70s} parent {p_ms[0]:.3f} / {p_ms[1]:.3f} ms, new "
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
