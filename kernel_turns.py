"""Time the port's segmented scans against the same kernels built from another
source tree, in turns, on one CUDA card.

    python3 kernel_turns.py PARENT_DIR [--runs N] [--grid] [--walls]

``PARENT_DIR`` holds an earlier checkout's ``alfred_margaret_tpu_torch/csrc``
(for example ``git archive <commit> alfred_margaret_tpu_torch/csrc | tar -x
-C PARENT_DIR``, in a directory ``.gitignore`` lists).  Its sources are
built with the port's ``nvcc`` flags.  B3's and B12's launchers are called
through the signatures of the tree before they took segments (bound below);
every other kernel through this tree's wrappers, with the parent's library
swapped in (their launchers did not change).  At the main paths' shapes (128
MiB, S = 32768, T = 4224; the mesh's shards of (4,2,1) at 4096 streams and
of (2,1,4) at 16384), each kernel runs in turns, parent, this tree, this
tree, parent, ``--runs`` launches a timing (CUDA events), and each pair's
outputs must be equal:

* B3, the dense sticky scan (``AMT_BITAP=0``'s and the dense engine's
  ``contains_any``): the bench needles (nearly every stream absorbs) and the
  miss needles (none does: a full scan) over the whole corpus, and the first
  and last quarter ranges of streams, as ``contains_staged_early`` launches
  them; site S6 on shard 0 of the (4,2,1) mesh, the miss needles;
* B12, the comb16 states: config 2's full tables;
* the kernels that must not move: B1 and B5 (B3's file), B8, B9, B11 (both
  modes, the one-group mode as site S4), B13 and S5 (B12's scan), B10 (B12's
  former file), and B2, B4 (with S3), B6 (bitap and dense steps), B7, S8,
  B15 and B17.

``--grid`` also times this tree's B3 (bench and miss needles), S6 and B12 at
other segment counts than their rule picks (the launcher alone), and B3's
lever: this tree's sources with B3's poll of ``out[s]`` taken out (the
block's vote alone, built into ``_build/vote``) against the vote and the
poll, in turns.  ``--walls`` times ``contains_any`` of 30 dense needles (the
four quarter launches), the bench needles' ``contains_any`` under
``AMT_BITAP=0``, the miss needles' ``contains_any`` on the (4,2,1) mesh's
dense route (8 x S6) and config 2's ``final_states_staged``, host clock until
the answer is on the host, with the parent's B3 and B12 swapped in for this
tree's, in turns.  Prints each timing, the card's name and power limit, and
one JSON line.  Needs one CUDA card and ``nvcc``; the parent's library goes
to ``alfred_margaret_tpu_torch/_build/parent``.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import glob
import json
import os
import sys
import time
from types import SimpleNamespace
from unittest import mock

import numpy as np

import chip_smoke as smoke


def _bind_parent(lib) -> None:
    """The launchers of the parent tree: this tree's signatures, but B3's and
    B12's before they took ``overlap`` and ``segments``."""
    from alfred_margaret_tpu_torch.kernels import build

    build._bind(lib)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.amt_dense_contains.argtypes = [p, i, i, p, p, i, p, i, i, i, i, i, p, p]
    lib.amt_comb16_states.argtypes = [p, i, i, p, p, i, p, i, p, p, i, i, i, i, p, p]


#: B3's poll of out[s] in ``csrc/dense_count.cu``, and the same line without
#: it: the lever ``--grid`` times (the block's vote alone).
POLL_LINE = "const bool stored = ld_relaxed(out + i) == (int32_t)absorb;"
VOTE_ALONE_LINE = "const bool stored = false;"


def build_vote_alone(out_dir: str):
    """This tree's ``csrc`` with B3's poll taken out (``POLL_LINE``), built
    with the port's flags into ``out_dir``; returns the bound library."""
    from alfred_margaret_tpu_torch.kernels import build
    from alfred_margaret_tpu_torch.utils.device import nvcc_path

    src = os.path.join(out_dir, "csrc")
    os.makedirs(src, exist_ok=True)
    for path in glob.glob(os.path.join(build._CSRC, "*.cu*")):
        with open(path) as f:
            text = f.read()
        if os.path.basename(path) == "dense_count.cu":
            if text.count(POLL_LINE) != 1:
                raise SystemExit("dense_count.cu: B3's poll line not found once")
            text = text.replace(POLL_LINE, VOTE_ALONE_LINE)
        with open(os.path.join(src, os.path.basename(path)), "w") as f:
            f.write(text)
    so = os.path.join(out_dir, "libvote.so")
    build._compile(nvcc_path(), sorted(glob.glob(os.path.join(src, "*.cu"))), so)
    lib = ctypes.CDLL(so)
    build._bind(lib)
    return lib


def build_parent(src_dir: str, out_dir: str):
    """Build the ``csrc/*.cu`` under ``src_dir`` with the port's flags into
    ``out_dir`` and bind its launchers by the parent's signatures; returns
    (the library, seconds)."""
    from alfred_margaret_tpu_torch.kernels import build
    from alfred_margaret_tpu_torch.utils.device import nvcc_path

    srcs = sorted(glob.glob(os.path.join(src_dir, "alfred_margaret_tpu_torch", "csrc", "*.cu")))
    if not srcs:
        raise SystemExit(f"no csrc/*.cu under {src_dir}")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, "libtree.so")
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
                    help="also time four operations (host clock until the answer is on the "
                         "host) with the parent's B3 and B12 swapped in and with this tree's, "
                         "in turns")
    ap.add_argument("--grid", action="store_true",
                    help="also time this tree's B3, S6 and B12 at other segment counts than "
                         "their rule picks, and B3 without its poll of out[s]")
    a = ap.parse_args()

    from alfred_margaret_tpu_torch import CASE_SENSITIVE, IGNORE_CASE, Searcher
    from alfred_margaret_tpu_torch import kernels as K
    from alfred_margaret_tpu_torch.bench.dataformat import synth_corpus
    from alfred_margaret_tpu_torch.kernels import build
    from alfred_margaret_tpu_torch.kernels.bitap_contains import bitap_contains_design
    from alfred_margaret_tpu_torch.kernels.bitap_count import bitap_count_design
    from alfred_margaret_tpu_torch.kernels.comb import comb_count_design
    from alfred_margaret_tpu_torch.kernels.comb16 import comb16_count_design
    from alfred_margaret_tpu_torch.kernels.comb16_grouped import comb16_grouped_design
    from alfred_margaret_tpu_torch.kernels.dense_contains import dense_contains_design
    from alfred_margaret_tpu_torch.kernels.dense_count import dense_count_design
    from alfred_margaret_tpu_torch.kernels.matchbits import matchbits_design
    from alfred_margaret_tpu_torch.ops import bitap_scan, comb16_scan, pallas_scan
    from alfred_margaret_tpu_torch.ops.bitap_scan import BitapAcEngine
    from alfred_margaret_tpu_torch.ops.comb16_scan import Comb16AcEngine
    from alfred_margaret_tpu_torch.ops.pallas_scan import DenseAcEngine
    from alfred_margaret_tpu_torch.parallel import DistributedAcEngine, make_mesh
    from alfred_margaret_tpu_torch.parallel import shard
    from alfred_margaret_tpu_torch.utils.device import nvidia_smi_line

    dev = torch.device("cuda", 0)
    card = nvidia_smi_line()
    t0 = time.perf_counter()
    new = build.load()
    out_dir = os.path.dirname(new.path)
    plib, parent_s = build_parent(a.parent, os.path.join(out_dir, "parent"))
    vlib = build_vote_alone(os.path.join(out_dir, "vote")) if a.grid else None
    print(f"built this tree and the parent in {time.perf_counter() - t0:.1f} s", flush=True)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    @contextlib.contextmanager
    def in_lib(lib):
        """This tree's wrappers launch from ``lib`` (None: this tree's)."""
        if lib is None:
            yield
            return
        with mock.patch.object(build, "load", lambda: SimpleNamespace(lib=lib)):
            yield

    def timed(fn, lib=None):
        with in_lib(lib):
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

    def dense_under_control(needles):
        """The searcher the dispatcher builds for ``needles`` with
        ``AMT_BITAP=0`` (the dense engine), and that engine."""
        with mock.patch.dict(os.environ, {"AMT_BITAP": "0"}):
            s = Searcher.build(CASE_SENSITIVE, needles)
            eng = s._engine.device_engine()
        assert type(eng) is DenseAcEngine, type(eng)
        return s, eng

    # -- the main paths' inputs ---------------------------------------------------------
    B = smoke.CORPUS_BYTES
    digits = np.frombuffer((smoke.DIGITS * (B // len(smoke.DIGITS) + 1))[:B], np.uint8)
    sb = Searcher.build(CASE_SENSITIVE, smoke.NEEDLES)
    bitap_eng = sb._engine.device_engine()
    sd, dense_eng = dense_under_control(smoke.NEEDLES)
    assert isinstance(bitap_eng, BitapAcEngine)
    datab = np.frombuffer(synth_corpus(smoke.NEEDLES, B, hit_fraction=0.01, seed=3), np.uint8)
    stgb = sb.stage(datab)
    stb = stgb.device
    stgd = sd.stage(datab)
    sm = Searcher.build(CASE_SENSITIVE, smoke.MISS_NEEDLES)
    miss_eng = sm._engine.device_engine()
    assert isinstance(miss_eng, BitapAcEngine)
    stm = sm.stage(datab).device
    _, miss_dense = dense_under_control(smoke.MISS_NEEDLES)
    stmd = miss_dense.stage(datab)
    m421 = make_mesh([dev] * 8, data=4, seq=2)
    eb, e_miss = sb.distributed(m421), sm.distributed(m421)
    assert eb.sticky_route() == e_miss.sticky_route() == "bitap"
    with mock.patch.dict(os.environ, {"AMT_BITAP": "0"}):
        e_miss_dense = DistributedAcEngine(sm.automaton, m421)
    assert e_miss_dense.sticky_route() == "dense"
    sbm, s_miss_m = eb.stage(datab), e_miss.stage(datab)
    # IgnoreCase: the case-scrambled bench corpus on the composed machine's
    # byte-class bitap (an embedded trap), and miss needles on the mesh.
    flip = np.random.default_rng(31).integers(0, 2, size=len(datab), dtype=np.uint8) == 1
    data_ci = datab.copy()
    data_ci[flip & (data_ci >= 97) & (data_ci <= 122)] -= 32
    s_ci = Searcher.build(IGNORE_CASE, smoke.NEEDLES)
    eng_ci = s_ci._engine._composed(IGNORE_CASE).device_engine()
    stg_ci = s_ci.stage(data_ci)
    st_ci = stg_ci.device
    assert stg_ci.composed and eng_ci.bitap.has_trap and eng_ci.bitap.trap is None
    e_miss_ci = Searcher.build(IGNORE_CASE, ["tshirt9", "shorts9"]).distributed(m421)
    s_miss_ci = e_miss_ci.stage(data_ci)
    assert e_miss_ci._bitap_lay.has_trap
    n30 = smoke.random_needles(30, 30)
    data30 = np.frombuffer(synth_corpus(n30, B, hit_fraction=0.01, seed=9), np.uint8)
    c30 = Comb16AcEngine(ac_build(n30), device=dev)
    st30 = c30.stage(data30)
    s30 = Searcher.build(CASE_SENSITIVE, n30)
    assert type(s30._engine.device_engine()) is DenseAcEngine
    stg30 = s30.stage(data30)
    n1000 = smoke.config5_needles(1000)
    s1000 = Searcher.build(CASE_SENSITIVE, n1000)
    eng5 = s1000._engine.device_engine()
    data5 = np.frombuffer(synth_corpus(n1000[:500], B, hit_fraction=0.01, seed=11), np.uint8)
    st5c = s1000.stage(data5).device
    st5d = s1000.stage(digits).device
    n300 = smoke.config5_needles(300)
    s300 = Searcher.build(CASE_SENSITIVE, n300)
    eng3 = s300._engine.device_engine()
    st3c = s300.stage(np.frombuffer(
        synth_corpus(n300, B, hit_fraction=0.01, seed=13), np.uint8)).device
    c2 = smoke.config2_needles()
    s100 = Searcher.build(CASE_SENSITIVE, c2)
    eng2 = s100._engine.device_engine()
    assert isinstance(eng2, Comb16AcEngine)
    ec2 = s100.distributed(make_mesh([dev] * 8, data=2, seq=1, needle=4))
    data2 = np.frombuffer(synth_corpus(c2, B, hit_fraction=0.01, seed=5), np.uint8)
    stg2 = s100.stage(data2)
    st2, st2d = stg2.device, s100.stage(digits).device
    sc2 = ec2.stage(data2)
    sff = ec2.stage(np.frombuffer(smoke.fire_free(B, seed=1), np.uint8))

    def shard0(eng, step, staged, **kw):
        i, g, d = eng.shards()[0]
        _, args, skw = eng.shard_call(step, staged, i, g, d, **kw)
        return args, skw

    s3_args, s3_kw = shard0(e_miss, "sticky", s_miss_m)
    s3t_args, s3t_kw = shard0(e_miss_ci, "sticky", s_miss_ci)
    s4_args, _ = shard0(ec2, "sticky", sff)
    s5_args, _ = shard0(ec2, "count", sc2)
    s6_args, s6_kw = shard0(e_miss_dense, "sticky", s_miss_m)
    s8_args, s8_kw = shard0(eb, "bits", sbm)
    torch.cuda.synchronize()

    # -- the parent's B3 and B12 --------------------------------------------------------
    def ptr(x):
        return x.data_ptr()

    def parent_b3(streams, cm, tab, vend, packing, state_bits, absorb, s0=0, s1=None,
                  overlap=None):
        """The parent's B3: one thread a whole stream (no overlap)."""
        T, S = streams.shape
        s1 = S if s1 is None else s1
        out = torch.empty(s1 - s0, dtype=torch.int32, device=dev)
        build.check(plib.amt_dense_contains(ptr(streams), T, S, ptr(cm), ptr(tab), tab.numel(),
                                            ptr(vend), packing, state_bits, absorb, s0, s1,
                                            ptr(out), stream()))
        return out

    def parent_b12(streams, cm, comb, aux, root_row, segtable, BB, om, CB, root_cb,
                   overlap=None):
        """The parent's B12: one thread a whole stream (no overlap)."""
        T, S = streams.shape
        out = torch.empty(T, S, dtype=torch.int32, device=dev)
        build.check(plib.amt_comb16_states(ptr(streams), T, S, ptr(cm), ptr(comb), comb.numel(),
                                           ptr(aux), aux.numel(), ptr(root_row), ptr(segtable),
                                           BB, om, CB, root_cb, ptr(out), stream()))
        return out

    def bits_kernel(overlap):
        return lambda *args, **kw: K.matchbits(*args, overlap=overlap)

    def bits_design(args, overlap):
        return matchbits_design(args[0], *args[3:], overlap=overlap)

    def b3_design(args, kw=None):
        over = kw["overlap"] if kw else args[9]
        return dense_contains_design(args[0], args[2], over, *args[7:9])

    def b4_design(args, kw=None):
        return bitap_contains_design(args[0], args[1], kw["overlap"] if kw else args[5])

    def b8_design(args):
        return comb16_count_design(args[0], args[4], args[5], args[13])

    def b12_design(args):
        return comb16_count_design(args[0], args[2], args[3], args[10])

    y5, f5 = eng5._fused_sticky_setup().tables, eng5._fused_setup().tables
    ob, o2, o8 = stb.plan.overlap, st2.plan.overlap, s8_kw["overlap"]
    bitap_args, dense_args, c16_args = (bitap_eng.bits_args(stb), dense_eng.bits_args(stb),
                                        eng2.bits_args(st2))
    S = stb.plan.n_streams
    b3_args, b3m_args = dense_eng.sticky_args(stb), miss_dense.sticky_args(stmd)
    b3q0_args = dense_eng.sticky_args(stb, 0, S // 4)
    b3q3_args = dense_eng.sticky_args(stb, 3 * S // 4, S)
    b12_args = eng2.states_args(st2)
    b4_args, b4m_args = bitap_eng.contains_args(stb), miss_eng.contains_args(stm)
    b4t_args = eng_ci.contains_args(st_ci)
    b8_args, b8n_args = eng2._kernel_args(st2), c30._kernel_args(st30)
    b2_args, b2t_args = bitap_eng._kernel_args(stb), eng_ci._kernel_args(st_ci)
    b1_args = dense_eng._kernel_args(stb)
    # (tag, what, this tree's call, the parent's call (None: this tree's wrapper
    # on the parent's library), args, kw, this tree's design (None: one thread
    # a whole stream))
    rows = [
        ("B3", "bench needles, whole corpus (stops at absorb)", K.dense_contains, parent_b3,
         b3_args, {}, b3_design(b3_args)),
        ("B3", "miss needles, whole corpus (full scan)", K.dense_contains, parent_b3, b3m_args,
         {}, b3_design(b3m_args)),
        ("B3", "bench needles, first quarter [0, S/4)", K.dense_contains, parent_b3, b3q0_args,
         {}, b3_design(b3q0_args)),
        ("B3", "bench needles, last quarter [3S/4, S)", K.dense_contains, parent_b3, b3q3_args,
         {}, b3_design(b3q3_args)),
        ("S6", "B3, miss needles, (4,2,1) shard 0", K.dense_contains, parent_b3, s6_args, s6_kw,
         b3_design(s6_args, s6_kw)),
        ("B12", "config 2's full tables", K.comb16_states, parent_b12, b12_args, {},
         b12_design(b12_args)),
        # The kernels that must not move: this tree's wrappers on either library.
        ("B1", "bench needles' dense tables", K.dense_count, None, b1_args, {},
         dense_count_design(b1_args[0], b1_args[2], b1_args[7])),
        ("B5", "bench needles' dense tables", K.dense_states, None, bitap_eng.states_args(stb),
         {}, None),
        ("B8", "config 2", K.comb16_count, None, b8_args, {}, b8_design(b8_args)),
        ("B8", "30 needles", K.comb16_count, None, b8n_args, {}, b8_design(b8n_args)),
        ("B9", "config 5", K.comb16_count_grouped, None, eng5._count_args(st5c), {},
         comb16_grouped_design(st5c.streams, f5, st5c.plan.overlap)),
        ("B11", "config 5, digits corpus: full scan", K.comb16_contains_grouped, None,
         eng5.sticky_args(st5d), {}, comb16_grouped_design(st5d.streams, y5, st5d.plan.overlap)),
        ("B11", "config 5 corpus: stops at the first match", K.comb16_contains_grouped, None,
         eng5.sticky_args(st5c), {}, comb16_grouped_design(st5c.streams, y5, st5c.plan.overlap)),
        ("S4", "B11 one-group, config 2 group 0, fire-free shard 0", K.comb16_contains_base,
         None, s4_args, {}, comb16_grouped_design(s4_args[0], s4_args[2], s4_args[3])),
        ("S5", "B9 one group, config 2 group 0, shard 0", K.comb16_count_grouped, None,
         s5_args, {}, comb16_grouped_design(s5_args[0], s5_args[3], s5_args[4])),
        ("B13", "config 2, comb16 step", bits_kernel(o2), None, c16_args, {},
         bits_design(c16_args, o2)),
        ("B10", "config 2, digits corpus: full scan", K.comb16_contains, None,
         eng2.sticky_args(st2d), {}, None),
        ("B4", "bench needles (V = 1, hits)", K.bitap_contains, None, b4_args, {},
         b4_design(b4_args)),
        ("B4", "miss needles (no hit: full scan)", K.bitap_contains, None, b4m_args, {},
         b4_design(b4m_args)),
        ("B4", "IgnoreCase bench needles, embedded trap", K.bitap_contains, None, b4t_args, {},
         b4_design(b4t_args)),
        ("S3", "B4, miss needles, (4,2,1) shard 0", K.bitap_contains, None, s3_args, s3_kw,
         b4_design(s3_args, s3_kw)),
        ("S3", "B4 trap part, IgnoreCase miss needles, (4,2,1) shard 0", K.bitap_contains,
         None, s3t_args, s3t_kw, b4_design(s3t_args, s3t_kw)),
        ("B2", "bench needles (V = 1)", K.bitap_count, None, b2_args, {},
         bitap_count_design(b2_args[0], b2_args[1], b2_args[5], b2_args[9])),
        ("B2", "IgnoreCase bench needles, embedded trap", K.bitap_count, None, b2t_args, {},
         bitap_count_design(b2t_args[0], b2t_args[1], b2t_args[5], b2t_args[9])),
        ("B7", "bench needles", K.bitap_presence, None, bitap_eng.sticky_bitap_args(stb), {},
         None),
        ("B6", "bench needles, bitap step", bits_kernel(ob), None, bitap_args, {},
         bits_design(bitap_args, ob)),
        ("B6", "bench needles, dense step", bits_kernel(ob), None, dense_args, {},
         bits_design(dense_args, ob)),
        ("S8", "B6 dense step, bench needles, (4,2,1) shard 0", bits_kernel(o8), None, s8_args,
         {}, bits_design(s8_args, o8)),
        ("B17", "config 5, 300 needles", K.comb_states, None, eng3.states_args(st3c), {},
         comb_count_design(st3c.streams, eng3.full_tables.comb, eng3.full_tables.def_table,
                           st3c.plan.overlap)),
        ("B15", "config 5, 300 needles", K.comb_count, None, eng3._kernel_args(st3c), {},
         comb_count_design(st3c.streams, eng3.tables.comb, eng3.tables.def_table,
                           st3c.plan.overlap)),
    ]

    def same(got, ref):
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        torch.cuda.synchronize()
        return max((int((g.long() - r.long()).abs().max()) if g.numel() else 0)
                   for g, r in zip(got, ref))

    def turns(tag, what, first, second, args, kw, lib_first, lib_second):
        """(first's ms, second's ms), each timed twice in turns first,
        second, second, first, after checking that they agree."""
        with in_lib(lib_first):
            ref = first(*args, **kw)
        with in_lib(lib_second):
            got = second(*args, **kw)
        err = same(got, ref)
        if err:
            raise SystemExit(f"{tag} {what}: outputs differ (max err {err})")
        ms = [(0, timed(lambda: first(*args, **kw), lib_first)),
              (1, timed(lambda: second(*args, **kw), lib_second)),
              (1, timed(lambda: second(*args, **kw), lib_second)),
              (0, timed(lambda: first(*args, **kw), lib_first))]
        return [m for w, m in ms if w == 0], [m for w, m in ms if w == 1]

    out = []
    for tag, what, kernel, parent, args, kw, design in rows:
        p_ms, n_ms = turns(tag, what, parent or kernel, kernel, args, kw, plib, None)
        d = design.as_dict() if design is not None else None
        print(f"turns {tag:4s} {what:55s} parent {p_ms[0]:.4f} / {p_ms[1]:.4f} ms, new "
              f"{n_ms[0]:.4f} / {n_ms[1]:.4f} ms ({d or 'unsegmented'}; {card})", flush=True)
        out.append({"kernel": tag, "what": what, "parent_ms": p_ms, "new_ms": n_ms, "design": d})

    grid, lever = [], []
    if a.grid:
        def b3_at(args, kw, k):
            """This tree's B3 launcher on ``args`` at ``k`` segments."""
            streams, cm, tab, vend, packing, state_bits, absorb = args[:7]
            s0, s1 = args[7:9] or (0, None)
            over = kw["overlap"] if kw else args[9]
            T, S_ = streams.shape
            s1 = S_ if s1 is None else s1
            res = torch.zeros(s1 - s0, dtype=torch.int32, device=dev)
            build.check(new.lib.amt_dense_contains(
                ptr(streams), T, S_, ptr(cm), ptr(tab), tab.numel(), ptr(vend), packing,
                state_bits, absorb, s0, s1, over, k, ptr(res), stream()))
            return res

        def b12_at(args, kw, k):
            """This tree's B12 launcher on ``args`` at ``k`` segments."""
            streams, cm, comb, aux, rr, seg, BB, om, CB, root_cb, over = args
            T, S_ = streams.shape
            res = torch.empty(T, S_, dtype=torch.int32, device=dev)
            build.check(new.lib.amt_comb16_states(
                ptr(streams), T, S_, ptr(cm), ptr(comb), comb.numel(), ptr(aux), aux.numel(),
                ptr(rr), ptr(seg), BB, om, CB, root_cb, over, k, ptr(res), stream()))
            return res

        for tag, at, kernel, args, kw in (("B3", b3_at, K.dense_contains, b3_args, {}),
                                          ("B3 miss", b3_at, K.dense_contains, b3m_args, {}),
                                          ("S6", b3_at, K.dense_contains, s6_args, s6_kw),
                                          ("B12", b12_at, K.comb16_states, b12_args, {})):
            ref = kernel(*args, **kw)
            for k in (1, 4, 8, 16, 32, 64):
                if same(at(args, kw, k), ref):
                    raise SystemExit(f"{tag} k={k}: != the rule's launch")
                ms = timed(lambda: at(args, kw, k))
                grid.append({"kernel": tag, "k": k, "ms": ms})
                print(f"grid {tag:7s} k={k:2d} {ms:.4f} ms ({card})", flush=True)

        # B3's lever: the block's vote alone (the poll of out[s] taken out)
        # against the vote and the poll, this tree's wrapper on both.
        for what, args, kw in (("bench needles, whole corpus", b3_args, {}),
                               ("miss needles, whole corpus", b3m_args, {}),
                               ("bench needles, first quarter", b3q0_args, {}),
                               ("S6, miss needles, (4,2,1) shard 0", s6_args, s6_kw)):
            v_ms, n_ms = turns("B3", what, K.dense_contains, K.dense_contains, args, kw, vlib,
                               None)
            print(f"lever B3   {what:40s} vote alone {v_ms[0]:.4f} / {v_ms[1]:.4f} ms, vote and "
                  f"poll {n_ms[0]:.4f} / {n_ms[1]:.4f} ms ({card})", flush=True)
            lever.append({"what": what, "vote_alone_ms": v_ms, "vote_and_poll_ms": n_ms})

    walls = []
    if a.walls:
        def wall_ms(fn, n=9):
            fn()
            times = []
            for _ in range(n):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            return float(np.median(times))

        parents = {"dense_contains": parent_b3, "comb16_states": parent_b12}

        @contextlib.contextmanager
        def parent_launchers():
            """The engines' and the mesh's B3 and B12 swapped for the parent's."""
            with contextlib.ExitStack() as stack:
                for mod in (pallas_scan, bitap_scan, comb16_scan, shard):
                    for name, fn in parents.items():
                        if hasattr(mod, name):
                            stack.enter_context(mock.patch.object(mod, name, fn))
                yield

        def answer(x):
            return x if not isinstance(x, np.ndarray) else int(x.astype(np.int64).sum())

        for tag, what, fn in (
                ("B3", "30 needles contains_any (K = 4 quarter launches)",
                 lambda: s30.contains_any(stg30)),
                ("B3", "bench needles contains_any, AMT_BITAP=0 control",
                 lambda: sd.contains_any(stgd)),
                ("S6", "miss needles contains_any, (4,2,1) mesh, dense route",
                 lambda: e_miss_dense.contains_any(s_miss_m)),
                ("B12", "config 2 final_states_staged", lambda: eng2.final_states_staged(st2))):
            got = fn()
            with parent_launchers():
                ref = fn()
            if not np.array_equal(got, ref):
                raise SystemExit(f"{tag} {what}: this tree's answer != the parent's")
            ts = []
            for lbl in ("parent", "new", "new", "parent"):
                with parent_launchers() if lbl == "parent" else contextlib.nullcontext():
                    ts.append((lbl, wall_ms(fn)))
            p_ms = [ms for lbl, ms in ts if lbl == "parent"]
            n_ms = [ms for lbl, ms in ts if lbl == "new"]
            print(f"wall  {tag:4s} {what:60s} parent {p_ms[0]:.3f} / {p_ms[1]:.3f} ms, new "
                  f"{n_ms[0]:.3f} / {n_ms[1]:.3f} ms (median of 9, host clock; answer "
                  f"{answer(got)}; {card})", flush=True)
            walls.append({"kernel": tag, "what": what, "parent_ms": p_ms, "new_ms": n_ms,
                          "answer": answer(got)})
    line = json.dumps({"turns": out, "lever": lever, "grid": grid, "walls": walls,
                       "card": card, "runs": a.runs, "parent_build_s": parent_s})
    print(card)
    print(line)
    return 0


def ac_build(needles):
    from alfred_margaret_tpu_torch.models import ac

    return ac.build([(n, i) for i, n in enumerate(needles)])


if __name__ == "__main__":
    sys.exit(main())
