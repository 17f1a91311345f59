"""Time the port's segmented scans against the same kernels built from another
source tree, in turns, on one CUDA card.

    python3 kernel_turns.py PARENT_DIR [--runs N] [--grid] [--walls]

``PARENT_DIR`` holds an earlier checkout's ``alfred_margaret_tpu_torch/csrc``
(for example ``git archive <commit> alfred_margaret_tpu_torch/csrc | tar -x
-C PARENT_DIR``, in a directory ``.gitignore`` lists).  Its sources are
built with the port's ``nvcc`` flags.  B7's launchers are called alone, the
parent's through the signatures of the tree before they took ``overlap``
and ``segments`` (bound below) into a ``torch.empty`` output, this tree's
at the segments its rule picks into a zeroed one, so that a launch of a
few dozen microseconds is not timed with the wrapper's host work; every
other kernel through this tree's wrappers, with the parent's library
swapped in (``parent_launch``: B7's launches without the two arguments they
took since).  At the main paths' shapes (128 MiB, S = 32768, T = 4224; the
mesh's shards of (4,2,1) at 4096 streams and of (2,1,4) at 16384, S7's at
16 MiB), each kernel runs in turns, parent, this tree, this tree, parent,
``--runs`` launches a timing (CUDA events), and each pair's outputs must be
equal:

* B7, the bitap presence scan: the bench needles (one word), and its trap
  part on the case-scrambled bench corpus with the IgnoreCase bench
  needles (a trap embedded in the word) and with ``chip_smoke.py``'s
  trap-register needles (two words: one and the register);
* the kernels that must not move: B1, B2 and B4 (each with its trap part;
  B4 with S3), B3 (with S6), B5 (with S7), B6 (bitap and dense steps), B8,
  B9, B10, B11 (both modes, the one-group mode as site S4), B12, B13, B14,
  B15, B16, B17, S5 and S8.

Before the turns it compares the machine code (``cuobjdump -sass``) of the
B2 and B4 instances of ``bitap_count_kernel`` in both libraries.
``--grid`` also times this tree's B7 launchers alone on the three inputs at
k = 1, 4, 8, 16, 32 and 64 segments.  ``--walls`` times ``contains_all``
through the ``Searcher`` on a staged haystack: on the bench needles and on
the IgnoreCase bench needles with their embedded trap (B7, then the host
reads the planes), and on that corpus with ``TSHİRT`` written into 100
streams (B7's trap fires, then the extraction route); host clock until the
answer is on the host, on the parent's library and on this tree's, in
turns, three times (the parent's B7 then writes into this tree's zeroed
output).
Prints each timing, the card's name and power limit, and one JSON line.
Needs one CUDA card and ``nvcc``; the parent's library goes to
``alfred_margaret_tpu_torch/_build/parent``.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import glob
import importlib
import json
import os
import re
import subprocess
import sys
import time
from types import SimpleNamespace
from unittest import mock

import numpy as np

import chip_smoke as smoke


def _bind_parent(lib) -> None:
    """The launchers of the parent tree: this tree's signatures, but B7's
    before they took ``overlap`` and ``segments``."""
    from alfred_margaret_tpu_torch.kernels import build

    build._bind(lib)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.amt_bitap_presence.argtypes = [p, i, i, p, p, p, i, p, p]
    lib.amt_bitap_presence_trap.argtypes = [p, i, i, p, p, p, p, i, p, p]


#: bitap_count_kernel<V, TRAP, STICKY or MODE>'s template arguments in its
#: mangled name: the parent's third is a bool (STICKY: B4, else B2), this
#: tree's an int (the mode: 0 B2, 1 B4, 2 B7).
_BITAP_INSTANCE = re.compile(r"bitap_count_kernelILi(\d+)ELb([01])EL[bi](\d+)EE")
_SASS_LINE = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.+?)\s*;")


def bitap_sass(so: str) -> dict:
    """The SASS instructions (``cuobjdump -sass``, addresses and encodings
    dropped) of each bitap_count_kernel instance in the library ``so``, by
    (V, TRAP, mode)."""
    from alfred_margaret_tpu_torch.utils.device import nvcc_path

    tool = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        return {}
    text = subprocess.run([tool, "-sass", so], capture_output=True, text=True,
                          check=True).stdout
    out, key = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            m = _BITAP_INSTANCE.search(line)
            key = tuple(int(x) for x in m.groups()) if m else None
            if key:
                out[key] = []
        elif key:
            m = _SASS_LINE.search(line)
            if m:
                out[key].append(m.group(1))
    return out


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
                    help="also time two contains_all operations (host clock until the answer "
                         "is on the host) on the parent's library and on this tree's, in turns")
    ap.add_argument("--grid", action="store_true",
                    help="also time this tree's B7 at other segment counts than its rule picks")
    a = ap.parse_args()

    from alfred_margaret_tpu_torch import CASE_SENSITIVE, IGNORE_CASE, Searcher
    from alfred_margaret_tpu_torch import kernels as K
    from alfred_margaret_tpu_torch.bench.dataformat import synth_corpus
    from alfred_margaret_tpu_torch.kernels import build
    from alfred_margaret_tpu_torch.kernels.bitap_contains import (bitap_contains_design,
                                                                  bitap_presence_design)
    from alfred_margaret_tpu_torch.kernels.bitap_count import bitap_count_design
    from alfred_margaret_tpu_torch.kernels.comb import comb_count_design
    from alfred_margaret_tpu_torch.kernels.comb16 import comb16_count_design
    from alfred_margaret_tpu_torch.kernels.comb16_grouped import comb16_grouped_design
    from alfred_margaret_tpu_torch.kernels.dense_contains import dense_contains_design
    from alfred_margaret_tpu_torch.kernels.dense_count import (dense_count_design,
                                                               dense_states_design)
    from alfred_margaret_tpu_torch.kernels.filter_contains import filter_contains_design
    from alfred_margaret_tpu_torch.kernels.matchbits import matchbits_design
    from alfred_margaret_tpu_torch.models import case_dfa
    from alfred_margaret_tpu_torch.ops.bitap_scan import BitapAcEngine, plan_bitap_ci
    from alfred_margaret_tpu_torch.ops.comb16_scan import Comb16AcEngine
    from alfred_margaret_tpu_torch.ops.comb_scan import CombAcEngine
    from alfred_margaret_tpu_torch.ops.pallas_scan import DenseAcEngine
    from alfred_margaret_tpu_torch.parallel import DistributedAcEngine, make_mesh
    from alfred_margaret_tpu_torch.utils.device import nvidia_smi_line

    dev = torch.device("cuda", 0)
    card = nvidia_smi_line()
    t0 = time.perf_counter()
    new = build.load()
    out_dir = os.path.dirname(new.path)
    plib, parent_s = build_parent(a.parent, os.path.join(out_dir, "parent"))
    print(f"built this tree and the parent in {time.perf_counter() - t0:.1f} s", flush=True)
    # B2's and B4's instances (modes 0 and 1) in both libraries: the same
    # machine code, or not.
    p_sass, n_sass = bitap_sass(os.path.join(out_dir, "parent", "libtree.so")), bitap_sass(new.path)
    shared = sorted(set(p_sass) & set(n_sass))
    same_sass = [k for k in shared if p_sass[k] == n_sass[k]]
    print(f"sass bitap_count_kernel<V, TRAP, mode> instances of both libraries: "
          f"{len(same_sass)} of {len(shared)} identical, differing "
          f"{sorted(set(shared) - set(same_sass))}; this tree's own: "
          f"{sorted(set(n_sass) - set(p_sass))}", flush=True)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def parent_launch(entry, device, *args):
        """This tree's launch of ``entry`` on the parent's library: B7's
        without the arguments it took since (``overlap`` and ``segments``)."""
        if entry in ("amt_bitap_presence", "amt_bitap_presence_trap"):
            args = args[:-3] + args[-1:]
        with torch.cuda.device(device):
            err = getattr(plib, entry)(*args, torch.cuda.current_stream().cuda_stream)
        build.check(err)

    wrapper_modules = [importlib.import_module(f"alfred_margaret_tpu_torch.kernels.{m}")
                       for m in ("bitap_contains",)]

    @contextlib.contextmanager
    def in_lib(lib):
        """This tree's wrappers launch from ``lib`` (None: this tree's; the
        parent's through ``parent_launch``)."""
        if lib is None:
            yield
            return
        with contextlib.ExitStack() as patches:
            patches.enter_context(mock.patch.object(build, "load",
                                                    lambda: SimpleNamespace(lib=lib)))
            if lib is plib:
                for mod in wrapper_modules:
                    patches.enter_context(mock.patch.object(mod, "launch", parent_launch))
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
        """A searcher over ``needles`` whose device engine is the dense
        engine (the control of a bitap-eligible set), and that engine."""
        s = Searcher.build(CASE_SENSITIVE, needles)
        s._engine._device_eng = eng = DenseAcEngine(s.automaton, device=s.device)
        return s, eng

    # -- the main paths' inputs ---------------------------------------------------------
    B = smoke.CORPUS_BYTES
    digits = np.frombuffer((smoke.DIGITS * (B // len(smoke.DIGITS) + 1))[:B], np.uint8)
    sb = Searcher.build(CASE_SENSITIVE, smoke.NEEDLES)
    bitap_eng = sb._engine.device_engine()
    _, dense_eng = dense_under_control(smoke.NEEDLES)
    assert isinstance(bitap_eng, BitapAcEngine)
    datab = np.frombuffer(synth_corpus(smoke.NEEDLES, B, hit_fraction=0.01, seed=3), np.uint8)
    stgb = sb.stage(datab)
    stb = stgb.device
    sm = Searcher.build(CASE_SENSITIVE, smoke.MISS_NEEDLES)
    miss_eng = sm._engine.device_engine()
    assert isinstance(miss_eng, BitapAcEngine)
    stm = sm.stage(datab).device
    _, miss_dense = dense_under_control(smoke.MISS_NEEDLES)
    stmd = miss_dense.stage(datab)
    m421 = make_mesh([dev] * 8, data=4, seq=2)
    eb, e_miss = sb.distributed(m421), sm.distributed(m421)
    assert eb.sticky_route() == e_miss.sticky_route() == "bitap"
    e_miss_dense = DistributedAcEngine(sm.automaton, m421)
    e_miss_dense._bitap_lay = None  # the mesh's dense steps
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
    # The trap-register layout of chip_smoke.py's timings (one word and the
    # register) on the same staging.
    m_reg = ac_build(smoke.TRAP_REGISTER_NEEDLES)
    cm_reg = case_dfa.compose_build(list(zip(m_reg.needles, m_reg.values)), machine=m_reg)
    eng_reg = BitapAcEngine(cm_reg, layout=plan_bitap_ci(cm_reg, max_words=2), device=dev)
    assert eng_reg.adopt_staged(st_ci) is st_ci and eng_reg.bitap.trap is not None
    # TSHİRT written into 100 streams, as in chip_smoke.py's trap phase: B7's
    # trap fires, and contains_all takes the extraction route.
    L_ci, tword = st_ci.plan.emit_len, np.frombuffer("TSHİRT".encode(), np.uint8)
    data_trap = data_ci.copy()
    for sid in np.random.default_rng(140).choice(st_ci.plan.n_streams, 100, replace=False):
        data_trap[sid * L_ci + 100: sid * L_ci + 100 + len(tword)] = tword
    stg_trap = s_ci.stage(data_trap)
    assert eng_ci.needle_presence_staged(stg_trap.device) is None
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
    stg5 = s1000.stage(data5)
    st5c = stg5.device
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
    stg2d = s100.stage(digits)
    st2, st2d = stg2.device, stg2d.device
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
    # S7: the states route of config 2 on (2,1,4) at 16 MiB (its plan's T = 640).
    s16 = ec2.stage(data2[:smoke.MESH_STATES_BYTES])
    s7_args, s7_kw = shard0(ec2, "states", s16)
    # B5 on the 30 dense needles' tables (packing 2) and B16 on config 5's
    # 300 needles, on the digits corpus (a full scan) and its own corpus.
    dense30 = s30._engine.device_engine()
    assert dense30.comp.packing == 2, dense30.comp.packing
    st30d = stg30.device
    assert isinstance(eng3, CombAcEngine)
    st3d = s300.stage(digits).device
    torch.cuda.synchronize()

    # -- the parent's B7 and this tree's, the launchers alone ---------------------------
    def ptr(x):
        return x.data_ptr()

    def b7_call(lib, args, k, out):
        """B7's launcher of ``lib`` on ``args`` (``presence_args``) into
        ``out``: ``k`` segments, or the parent's signature for None."""
        streams, btab, seed, endmask, trapmask, over = args
        T, S_ = streams.shape
        head = (ptr(streams), T, S_, ptr(btab), ptr(seed), ptr(endmask))
        if trapmask is not None:
            head += (ptr(trapmask),)
        tail = (btab.shape[0],) + (() if k is None else (over, k)) + (ptr(out), stream())
        fn = lib.amt_bitap_presence if trapmask is None else lib.amt_bitap_presence_trap
        build.check(fn(*head, *tail))
        return out

    def parent_b7(*args):
        """The parent's B7: one thread a whole stream (no segments), every
        plane word written."""
        V, S_ = args[1].shape[0], args[0].shape[1]
        return b7_call(plib, args, None, torch.empty(V, S_, dtype=torch.int32, device=dev))

    def b7_at(lib, args, k):
        """B7's launcher of ``lib`` at ``k`` segments, into a zeroed output
        as the wrapper's."""
        V, S_ = args[1].shape[0], args[0].shape[1]
        return b7_call(lib, args, k, torch.zeros(V, S_, dtype=torch.int32, device=dev))

    def b7_design(args):
        return bitap_presence_design(args[0], args[1], args[5])

    def b7_rule(*args):
        """This tree's B7 launcher alone at the segments its rule picks."""
        return b7_at(new.lib, args, b7_design(args).segments)

    def bits_kernel(overlap):
        return lambda *args, **kw: K.matchbits(*args, overlap=overlap)

    def bits_design(args, overlap):
        return matchbits_design(args[0], *args[3:], overlap=overlap)

    def b3_design(args, kw=None):
        over = kw["overlap"] if kw else args[9]
        return dense_contains_design(args[0], args[2], over, *args[7:9])

    def b4_design(args, kw=None):
        return bitap_contains_design(args[0], args[1], kw["overlap"] if kw else args[5])

    def b5_design(args, kw=None):
        return dense_states_design(args[0], args[2], kw["overlap"] if kw else args[5])

    def b8_design(args):
        return comb16_count_design(args[0], args[4], args[5], args[13])

    def b10_design(args):
        return comb16_count_design(args[0], args[3], args[4], args[11])

    def b12_design(args):
        return comb16_count_design(args[0], args[2], args[3], args[10])

    def b14_design(args):
        return filter_contains_design(args[0], args[2], args[7], args[8])

    def b16_design(args):
        return comb_count_design(args[0], args[3], args[4], args[10])

    y5, f5 = eng5._fused_sticky_setup().tables, eng5._fused_setup().tables
    ob, o2, o8 = stb.plan.overlap, st2.plan.overlap, s8_kw["overlap"]
    bitap_args, dense_args, c16_args = (bitap_eng.bits_args(stb), dense_eng.bits_args(stb),
                                        eng2.bits_args(st2))
    S = stb.plan.n_streams
    b3_args, b3m_args = dense_eng.sticky_args(stb), miss_dense.sticky_args(stmd)
    b3q0_args = dense_eng.sticky_args(stb, 0, S // 4)
    b5_args, b5p_args = bitap_eng.states_args(stb), dense30.states_args(st30d)
    b16d_args, b16c_args = eng3.sticky_args(st3d), eng3.sticky_args(st3c)
    b10d_args, b10c_args = eng2.sticky_args(st2d), eng2.sticky_args(st2)
    b14_args = (st2.streams, st2.vend, *eng2._filter_tables.args(), st2.plan.overlap)
    b14_args5 = (st5c.streams, st5c.vend, *eng5._filter_tables.args(), st5c.plan.overlap)
    b12_args = eng2.states_args(st2)
    b7_args = {"bench needles": bitap_eng.presence_args(stb),
               "IgnoreCase bench needles, embedded trap": eng_ci.presence_args(st_ci),
               "IgnoreCase 5 needles, trap register": eng_reg.presence_args(st_ci)}
    b4_args, b4m_args = bitap_eng.contains_args(stb), miss_eng.contains_args(stm)
    b4t_args = eng_ci.contains_args(st_ci)
    b8_args, b8n_args = eng2._kernel_args(st2), c30._kernel_args(st30)
    b2_args, b2t_args = bitap_eng._kernel_args(stb), eng_ci._kernel_args(st_ci)
    b2r_args = eng_reg._kernel_args(st_ci)
    b1_args = dense_eng._kernel_args(stb)
    # (tag, what, this tree's call, the parent's call (None: this tree's wrapper
    # on the parent's library), args, kw, this tree's design (None: one thread
    # a whole stream))
    rows = [
        *(("B7", what, b7_rule, parent_b7, args, {}, b7_design(args))
          for what, args in b7_args.items()),
        # The kernels that must not move: this tree's wrappers on either library.
        ("B5", "bench needles' dense tables (packing 1)", K.dense_states, None, b5_args, {},
         b5_design(b5_args)),
        ("B5", "30 needles' dense tables (packing 2)", K.dense_states, None, b5p_args, {},
         b5_design(b5p_args)),
        ("S7", "B5, config 2 group 0, 16 MiB, (2,1,4) shard 0", K.dense_states, None,
         s7_args, s7_kw, b5_design(s7_args, s7_kw)),
        ("B16", "config 5's 300, digits corpus: full scan", K.comb_contains, None, b16d_args,
         {}, b16_design(b16d_args)),
        ("B16", "config 5's 300, config 5 corpus: first match", K.comb_contains, None,
         b16c_args, {}, b16_design(b16c_args)),
        ("B14", "config 2, 3 words", K.filter_contains, None, b14_args, {},
         b14_design(b14_args)),
        ("B14", "config 5, 12 words", K.filter_contains, None, b14_args5, {},
         b14_design(b14_args5)),
        ("B10", "config 2, digits corpus: full scan", K.comb16_contains, None, b10d_args, {},
         b10_design(b10d_args)),
        ("B10", "config 2 corpus: stops at the first match", K.comb16_contains, None,
         b10c_args, {}, b10_design(b10c_args)),
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
        ("B12", "config 2's full tables", K.comb16_states, None, b12_args, {},
         b12_design(b12_args)),
        ("B13", "config 2, comb16 step", bits_kernel(o2), None, c16_args, {},
         bits_design(c16_args, o2)),
        ("B1", "bench needles' dense tables", K.dense_count, None, b1_args, {},
         dense_count_design(b1_args[0], b1_args[2], b1_args[7])),
        ("B3", "bench needles, whole corpus (stops at absorb)", K.dense_contains, None,
         b3_args, {}, b3_design(b3_args)),
        ("B3", "miss needles, whole corpus (full scan)", K.dense_contains, None, b3m_args,
         {}, b3_design(b3m_args)),
        ("B3", "bench needles, first quarter [0, S/4)", K.dense_contains, None, b3q0_args,
         {}, b3_design(b3q0_args)),
        ("S6", "B3, miss needles, (4,2,1) shard 0", K.dense_contains, None, s6_args, s6_kw,
         b3_design(s6_args, s6_kw)),
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
        ("B2", "IgnoreCase 5 needles, trap register", K.bitap_count, None, b2r_args, {},
         bitap_count_design(b2r_args[0], b2r_args[1], b2r_args[5], b2r_args[9])),
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

    grid = []
    if a.grid:
        # This tree's B7 launchers alone at other segment counts, each output
        # held against the wrapper's at the rule's.
        for what, args in b7_args.items():
            ref = K.bitap_presence(*args)
            for k in (1, 4, 8, 16, 32, 64):
                if same(b7_at(new.lib, args, k), ref):
                    raise SystemExit(f"B7 {what} k={k}: != the rule's launch")
                ms = timed(lambda: b7_at(new.lib, args, k))
                grid.append({"kernel": "B7", "what": what, "k": k, "ms": ms})
                print(f"grid B7 {what:40s} k={k:2d} {ms:.4f} ms ({card})", flush=True)

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

        for tag, what, fn in (
                ("B7", "contains_all, bench needles (B7, planes read on the host)",
                 lambda: sb.contains_all(stgb)),
                ("B7", "contains_all, IgnoreCase bench needles, embedded trap (B7)",
                 lambda: s_ci.contains_all(stg_ci)),
                ("B7+B6", "contains_all, IgnoreCase, TSHİRT in 100 streams (B7, then extraction)",
                 lambda: s_ci.contains_all(stg_trap))):
            got = fn()
            with in_lib(plib):
                ref = fn()
            if got != ref:
                raise SystemExit(f"{tag} {what}: this tree's answer != the parent's")
            ts = []
            for lbl in ("parent", "new", "new", "parent") * 3:
                with in_lib(plib if lbl == "parent" else None):
                    ts.append((lbl, wall_ms(fn)))
            p_ms = [ms for lbl, ms in ts if lbl == "parent"]
            n_ms = [ms for lbl, ms in ts if lbl == "new"]
            print(f"wall  {tag:7s} {what:64s} parent {' / '.join(f'{m:.3f}' for m in p_ms)} ms, "
                  f"new {' / '.join(f'{m:.3f}' for m in n_ms)} ms (median of 9 each, host "
                  f"clock; answer {got}; {card})", flush=True)
            walls.append({"kernel": tag, "what": what, "parent_ms": p_ms, "new_ms": n_ms,
                          "answer": got})
    line = json.dumps({"turns": out, "grid": grid, "walls": walls,
                       "sass_identical": [list(k) for k in same_sass],
                       "card": card, "runs": a.runs, "parent_build_s": parent_s})
    print(card)
    print(line)
    return 0


def ac_build(needles):
    from alfred_margaret_tpu_torch.models import ac

    return ac.build([(n, i) for i, n in enumerate(needles)])


if __name__ == "__main__":
    sys.exit(main())
