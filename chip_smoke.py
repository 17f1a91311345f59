"""Drive the PyTorch port's Searcher once on one NVIDIA GPU.

Run from the repository root on a host with one CUDA card (an H100):

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``alfred_margaret_tpu_torch/csrc``
(one ``nvcc`` per source, all at once) and checks each of the seventeen
kernels (and B11's one-group mode, on the mesh phase's tables) and the
grouped engine's suffix-screen count ``screen_count`` against its
plain torch version on the card on nineteen machines, and
the trap parts of B2, B4 and B7 on three IgnoreCase layouts, and the
engines' answers (``final_states`` and the extraction without the host
corpus too) against the port's host C++ engine.  Then it drives thirteen main
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
  scan (B10) decides; the same with the screen detached as the control;
  ``contains_all`` true and false and ``all_matches_arrays`` (B6 with the
  comb16 step, B13);
* ``BASELINE.json`` config 5's first 300 needles, which overflow comb16, on
  the comb32 engine: ``stage`` -> ``count_matches`` (B15), ``contains_any``
  on the config-5 corpus, the digits corpus and the digits corpus with one
  needle in it (B16), ``contains_all`` true and false and
  ``all_matches_arrays`` (B15, then B17);
* ``BASELINE.json`` config 5's first 1,000 needles, which no single-pass
  engine holds, on the needle-grouped engine (seven comb32 groups and one
  comb16 group, as in the JAX package): ``stage`` -> ``count_matches``
  (``screen_count``, one launch; B9 over the uniform groups as its control),
  ``contains_any`` through the 12-word
  screen (B14) and then B11 on the config-5 corpus, a fire-free corpus, the
  digits corpus and the digits corpus with one needle of the last group;
  ``contains_all`` true and false and ``all_matches_arrays`` (B15 and B17 for
  each comb32 group, B13 for the comb16 group); with the groups' own passes
  (per-group B15, B16, B8 and B10: the fused table sets left unbuilt) and the
  screen detached (B11 alone) as the controls, each a second grouped engine
  over the same machine;
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
  B6's dense step for extraction), with the dense engine (B1, B3 and B6 on
  the composed machine) as the control; the same corpus with ``TSHİRT``
  written into 100 streams (the trapped streams re-counted on the host) and
  into 1,000 (the dense fallback, B1); config 2's 100 needles on the
  composed machine's comb16 tables (B8, B10, B13); and the lowering path:
  config 5's first 600 needles, whose composed machine no single-pass
  engine holds, lowered on the host (32 MiB) and scanned by the grouped
  engine.  Answers against the host C++ engine on the composed machine (or,
  on the lowering path, on the lowered bytes with the ends mapped back), and
  the python IgnoreCase oracle on 64 KiB with the case probes (İ, Ⱥ, Kelvin
  K, Å, ẞ);
* the reference's other operations (``api_phase``, at 128 MiB), after the
  host C++ library is checked for the Replacer's five entry points:
  ``Replacer.run`` on config 4's pairs (the batched splice; one-shot and on
  a staged handle; B6's bitap step), on a cascading set (the incremental
  loop's window rescans), on config 2's 100 needles upper-cased (B13, over
  32 MiB) and
  under IgnoreCase (composed, on a staging of the scrambled bench corpus;
  the lowering fallback on 1 MiB one-shot, against the python Replacer; and
  config 4's and the cascading pairs composed on a staging of that 1 MiB,
  against the python Replacer's lowering path), each output equal to a
  sequential ``bytes.replace`` and the host C++ Replacer's, a lowered
  staging refused; ``Splitter.split`` and ``split_ignore_case`` on
  ``shorts`` (``bytes.split``, the host C++ Splitter);
  ``Searcher.adopt_staged`` of the bench staging into the bitap searcher
  (the streams reused) and the composed IgnoreCase one (restaged), and of a
  staging of a corpus holding every tier's needles, at the widest overlap
  they need, into the dense, comb16, comb32, grouped and composed
  IgnoreCase searchers (the streams reused), each count (above 0) and
  ``contains_any`` equal to the host C++ engine's; and ``boyer_moore`` /
  ``boyer_moore_ci`` ``contains_any`` and ``contains_all`` (true and false)
  over 128 MiB, through the AC route on the card, against the host C++
  engine;
* the sharded engine (``parallel.DistributedAcEngine`` through
  ``Searcher.distributed``) on meshes of eight shards of the one card
  (``make_mesh(["cuda:0"] * 8, ...)``), each operation launching its step
  once per shard: the bench needles on (4,2,1) (count S2, ``contains_any``
  on a hit and a miss S3, ``contains_all`` true and false and
  ``all_matches_arrays`` S8; the dense steps, the bitap layout taken away,
  as the control, S1 and S6);
  the same under IgnoreCase on the composed machine (S2 and S3 with their
  trap parts; ``TSHİRT`` in 100 streams, the host recount, and in 1,000, the
  dense fallback, S1 and S6); 30 random needles on (2,2,2) (the uniform
  comb16 count S5 and B11's one-group mode S4; the dense steps, the comb16
  tables taken away, as the control); config 2 on (2,1,4) (S5, S4 on its corpus and a fire-free one,
  S8, and at 16 MiB without the host corpus the states route S7); and one
  count inside a one-rank NCCL group, its reduction an ``all_reduce`` of a
  CUDA tensor.  Every mesh answer must equal the single-device
  ``Searcher``'s; each launch site's kernel is held against its plain version
  on one shard and timed there;
* streaming past the device budget (``stream_phase``, ``ops/streaming.py``
  through ``MatchEngine``): the bench needles over a memmap of 2 GiB +
  12,345 bytes, 16 chunks of 128 MiB and a ragged one, each staged on the
  card in turn: ``count_matches`` (B2; B1 on the dense engine as the control),
  ``contains_any`` of a hit and of the miss needles (B4; B3 as the control)
  and
  ``all_matches_arrays`` (B6), equal to the host C++ engine over the file and
  to the corpus staged whole on the card, and again at chunks of 64 and 96
  MiB; config 2 (B8, B14, B10, B13), config 5's first 300 (B15, B16, B17)
  and first 1,000 (``screen_count``, B14, B11, extraction), composed IgnoreCase with
  ``TSHİRT`` across the cuts (the trap parts of B2 and B4, B6) and the
  lowering path on config 5's first 600 (count and ``contains_any``), each
  over 512 MiB; ``Searcher.stage`` past the budget (no device staging, its
  scans stream); a count under ``AMT_VALIDATE=1``; the mesh (4,2,1)
  streaming 3 chunks (S2, S3, S8) against the single-device ``Searcher``;
  the host C++ library's prefilter (``cpp`` backend, config 5's first 2,000
  needles, ``AMT_PREFILTER=1``, ``=0`` and the automatic rule) and host
  bitap oracle; and the walls: the streamed count per GiB, the whole-corpus
  staging and count, a grid of chunk sizes (32 to 512 MiB) and one chunk's
  staging against its kernel.

* the tools (``tools_phase``): ``dump-automaton`` against
  ``debug_build_dot``; ``count-matches`` through ``cli`` in a fresh
  interpreter on two bench files, with ``AMT_ENGINE`` ``auto`` (B2),
  ``pallas`` (B1) and ``cpp``, their counts equal and the host C++
  engine's; ``driver.run_benchmark`` of it, 2 runs, and ``report``;
  ``configs.main(["--mb", "32"])`` (each config's gates, and at least one
  launch each; config 5's 10,000 needles build the grouped engine once);
  ``micro``; ``scaling`` on 1, 2, 4 and 8 shards of the card (S2); the
  serving demo; and the device's idle share read from ``torch.profiler``
  traces (``utils/trace.py``) of a staged count, ``contains_any`` and
  ``all_matches_arrays`` of the bench needles at 128 MiB and a count
  streamed over 4 chunks.

Every answer must equal the host C++ engine's (and the control's), and every
kernel of a path must have been launched by it.  The segmented kernels (B1,
B2, B4 and B7 with their trap parts, B3, B5, B6 with its dense and bitap
steps, B8, B9, B10, B11 in both modes, B12, B13, B14, B15, B16 and B17:
every kernel) are also
held against their plain versions at ragged edge shapes: one stream, S not
a multiple of 128 or of 16, T of one tile or word, ragged warm-ups and
vends, with the plan's overlap, with none and with every stream padded (B2
also on 1, 2, 3 and 8 words and B4 and B7 on 1, 2 and 3, all on their trap
layouts, İ, Kelvin K and ẞ written across the segment cuts; B3, B4, B5, B7,
B8, B10, B12, B14 and B16 also at k = 1, 2, 3, 7, 16 and 64 forced, B14 on 0, 1, 3 and 12
words and odd vends; B3 over stream ranges whose start is not a multiple of
16; B3, B5 and B16 on a composed IgnoreCase machine); the launches of
B1-B5, B7, B8, B10, B12, B14, B16, S1-S3, S6 and S7 print their segment counts
(B3, B5, B10, B12, B14, B16, S6 and S7 with their shared memory and blocks
per SM, B14 with its table layout).  Last it times every kernel (the trap
parts on the IgnoreCase bench staging, with an embedded trap and with a
trap register; B3 also as the dense path's four quarter launches, its
Excess taken at that shape; B5 also on the 30 dense needles' packing-2
tables, its Excess with S7's; B10, B14 and B16 with theirs at their main
paths' shapes) and its plain version with CUDA events,
B8 against B1 on one 30-needle set that both engines hold, and B9 against
the per-group B15 and B8 passes it replaces, beside the host C++ engine's
count.  Any failure raises and the exit code is non-zero.  Without a CUDA device it exits non-zero before printing a result.

The last three lines of standard output are the kernels' JSON summary, the
card's ``nvidia-smi`` name and power limit, and ``{"ok": true, "device":
{...}}``.
"""

import dataclasses
import json
import os
import sys
import time
from types import SimpleNamespace
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
#: Stream lengths of the edge-shape checks: one tile, several, and many
#: tiles and segments, the longest ragged (not a whole 32-step tile); B6 and
#: B13 at whole 32-step words.
EDGE_TS = (20, 300, 1000)
EDGE_TS_WORDS = (32, 320, 1024)
PLAIN_RUNS = 1  # after a warm-up: the plain versions take 0.03-2.4 s a call
#: The corpus of ``alfred_margaret_tpu/bench/configs.py`` config 2b.
DIGITS = b"0123456789 ,;:!"
#: H100 SXM data sheet: HBM3 bandwidth, and the float32 rate outside the
#: tensor cores, taken as the card's rate for 32-bit integer work.
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12
#: Needles of two bitap words, and 30 needles at dense packing 2.
TWO_WORD_NEEDLES = ["alpha", "bravo", "charlie", "delta", "echo", "foxtrot", "golf"]
PACK2_NEEDLES = [bytes([97 + i % 11, 98 + (i * 3) % 9, 99 + i % 7]).decode() for i in range(30)]
_RNG8 = np.random.default_rng(5)
#: Needles of eight bitap words: distinct random six-letter words.
EIGHT_WORD_NEEDLES = list(dict.fromkeys(
    "".join(chr(97 + c) for c in _RNG8.integers(0, 26, size=6)) for _ in range(30)))
#: IgnoreCase needles whose layout holds a trap register (beside one bitap
#: word, and beside two).
TRAP_REGISTER_NEEDLES = ["tshirt", "shirts", "shorts", "kilo", "café"]
TRAP_REGISTER_V3_NEEDLES = TRAP_REGISTER_NEEDLES + ["alpha", "bravo", "charlie", "delta"]
#: İ, Kelvin K and ẞ: unlowerings that change the byte length (trap tracks).
CI_TRAPS = ("\u0130", "\u212a", "\u1e9e")


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def random_needles(seed: int, n: int):
    """``n`` distinct random lower-case needles of 4 to 8 letters, drawn as
    ``alfred_margaret_tpu_torch/bench/configs.py`` draws config 2's (the
    configs' own draws are ``config2_needles`` and ``config5_needles``
    there)."""
    rng = np.random.default_rng(seed)
    return list(dict.fromkeys(
        "".join(chr(97 + c) for c in rng.integers(0, 26, size=rng.integers(4, 9)))
        for _ in range(int(n * 1.1))
    ))[:n]


def fire_free(n: int, seed: int = 0) -> bytes:
    """``n`` random bytes over ``b"0 "``: no chain of config 2's screen fires."""
    rng = np.random.default_rng(seed)
    return rng.choice(np.frombuffer(b"0 ", np.uint8), n).astype(np.uint8).tobytes()


def plant_traps(a: np.ndarray, k: int, K: int) -> None:
    """Write İ, Kelvin K and ẞ across each cut of ``k`` segments of overlap
    ``K`` (mid-stream for one segment) into ``a`` (uint8 [T, S], in place):
    trap j of cut i in stream 3i + j (mod S)."""
    from alfred_margaret_tpu_torch.kernels.segments import segment_schedule

    T, S = a.shape
    cuts = [lo for _, lo, _ in segment_schedule(T, k, K)[1:]] or [T // 2]
    for i, p in enumerate(cuts):
        for j, enc in enumerate(CI_TRAPS):
            b = np.frombuffer(enc.encode(), np.uint8)
            if 1 <= p and p - 1 + len(b) <= T:
                a[p - 1:p - 1 + len(b), (3 * i + j) % S] = b


def design_of(design, smem: int) -> dict:
    """A launch's design (``kernels/segments.py:Design``) with its block's
    dynamic shared memory and the blocks an H100 SM holds at that size."""
    from alfred_margaret_tpu_torch.kernels.segments import (
        MAX_BLOCKS_PER_SM, SMEM_PER_SM)

    return {**design.as_dict(), "smem": smem,
            "blocks_per_sm": max(1, min(MAX_BLOCKS_PER_SM, SMEM_PER_SM // (smem + 1024)))}


def sticky_groups(sticky16, G: int):
    """``G`` copies of one comb16 sticky table set (``Comb16AcEngine.
    sticky_tables()``) as B11's group tables."""
    import torch

    from alfred_margaret_tpu_torch.ops.comb16_scan import Comb16GroupTables

    def stack(x):
        return x.unsqueeze(0).expand(G, -1).contiguous()

    gscal = torch.tensor([[sticky16.root_cb, sticky16.absorb]] * G, dtype=torch.int32,
                         device=sticky16.comb.device)
    return Comb16GroupTables(
        classmap=stack(sticky16.classmap), comb=stack(sticky16.comb), aux=stack(sticky16.aux),
        root_row=stack(sticky16.root_row), segtable=stack(sticky16.segtable), gscal=gscal,
        gscal_host=((sticky16.root_cb, sticky16.absorb),) * G, BB=sticky16.BB,
        owner_mask=sticky16.owner_mask, CB=sticky16.CB, sticky=True)


#: The sharded engine's launch sites: wrapper (trap parts apart) -> (site,
#: line of its ``pl.pallas_call`` in ``alfred_margaret_tpu/parallel/shard.py``).
MESH_SITES = {
    "dense_count": ("S1", 325), "bitap_count": ("S2", 434), "bitap_count_trap": ("S2", 434),
    "bitap_contains": ("S3", 509), "bitap_contains_trap": ("S3", 509),
    "comb16_contains_base": ("S4", 616), "comb16_count_grouped": ("S5", 696),
    "dense_contains": ("S6", 997), "dense_states": ("S7", 1134), "matchbits": ("S8", 1219),
}
MESH_STATES_BYTES = 16 << 20  # corpus of the states route: [G, T, S] int32 on the host

#: The Replacer's pairs of ``BASELINE.json`` config 4 (the JAX package's
#: ``bench/configs.py``), and a set whose replacements create matches of
#: lower priorities (the incremental pass loop).
CONFIG4_PAIRS = [("tshirt", "TEE"), ("shirts", "SHIRT"), ("shorts", "S"), ("ee", "f")]
CASCADE_PAIRS = [("tshirt", "shirts"), ("shirts", "shorts"), ("shorts", "x")]
#: The part of config 2's corpus that its Replacer runs over: 100 host passes
#: (each splicing, then a sequential ``bytes.replace`` per needle as the gate)
#: at 128 MiB took 33 s of the run.
API_CONFIG2_BYTES = 32 << 20
#: The Replacer's entry points in the host C++ library.
REPLACER_SYMBOLS = ("am_scan_segments_hits", "am_splice", "am_splice_mt", "am_splice_multi",
                    "am_remove_overlap")


def mesh_phase(h):
    """The sharded engine on meshes of the one card (``make_mesh([dev] * 8)``):
    each operation against the single-device ``Searcher``'s answer, with the
    kernels it must launch (8 shards, one launch each); each launch site's
    kernel against its plain version on shard 0, timed; and a one-rank NCCL
    group around a count.  ``h`` carries ``main``'s helpers and stagings.
    Returns (main-path launches, control launches, per-site timings)."""
    import tempfile

    import torch

    from alfred_margaret_tpu_torch import CASE_SENSITIVE, Searcher
    from alfred_margaret_tpu_torch.bench.dataformat import synth_corpus
    from alfred_margaret_tpu_torch.parallel import DistributedAcEngine, init_distributed, make_mesh
    from alfred_margaret_tpu_torch.kernels.bitap_contains import bitap_contains_design
    from alfred_margaret_tpu_torch.kernels.bitap_count import bitap_count_design
    from alfred_margaret_tpu_torch.kernels.comb16_grouped import comb16_grouped_design
    from alfred_margaret_tpu_torch.kernels.dense_contains import dense_contains_design
    from alfred_margaret_tpu_torch.kernels.dense_count import dense_count_design, dense_states_design
    from alfred_margaret_tpu_torch.kernels.matchbits import matchbits_design
    from alfred_margaret_tpu_torch.kernels.segments import dense_bits_smem_bytes
    from alfred_margaret_tpu_torch.parallel.shard import PLAIN

    dev, card = h.dev, h.card

    def mesh(d, s, n):
        return make_mesh([dev] * (d * s * n), data=d, seq=s, needle=n)

    def dense_steps(machine, m, tables):
        """The mesh engine of ``machine`` on ``m`` with its ``tables``
        (``_bitap_lay`` or ``_c16g``) taken away: the mesh's dense steps."""
        eng = DistributedAcEngine(machine, m)
        setattr(eng, tables, None)
        return eng

    def routes(eng, count, sticky, label):
        check(eng.inner == "pallas" and (eng.count_route(), eng.sticky_route()) == (count, sticky),
              f"mesh {label}: inner {eng.inner}, routes {eng.count_route()}/{eng.sticky_route()}")

    def staged(eng, corpora, label):
        t0 = time.perf_counter()
        out = [eng.stage(c) for c in corpora]
        torch.cuda.synchronize()
        sst = out[0]
        T, SL = sst.plan.time_len, sst.plan.n_streams // eng.n_stream_shards
        print(f"mesh {label}: staged {len(corpora)} x {len(corpora[0])} bytes in "
              f"{time.perf_counter() - t0:.3f} s: {sst.plan}, {len(sst.blocks)} blocks of "
              f"[{T}, {SL}] on {sorted({str(d) for _, d in sst.blocks})}", flush=True)
        return out

    main, control = {}, {}

    def drive(rows, want):
        """Each ``(operation, who, call, kernels)``: the answer equals
        ``want[operation]`` and the launches are exactly ``kernels``."""
        expect = {(op, who): k for op, who, _, k in rows}
        for op, who, used in h.run_ops([(op, who, call) for op, who, call, _ in rows], want):
            check(used == expect[(op, who)],
                  f"mesh {op} ({who}): launched {used}, expected {expect[(op, who)]}")
            h.tally(control if "control" in who else main, used)

    m421, m222, m214 = mesh(4, 2, 1), mesh(2, 2, 2), mesh(2, 1, 4)
    N = 8  # shards, one launch each per step

    # -- the bench needles on (4,2,1): bitap (S2, S3), bitmap (S8) ----------
    eb = h.searcher.distributed(m421)
    e_miss, e_absent = h.miss.distributed(m421), h.absent.distributed(m421)
    routes(eb, "bitap", "bitap", "bench needles")
    eb_dense = dense_steps(h.searcher.automaton, m421, "_bitap_lay")
    e_miss_dense = dense_steps(h.miss.automaton, m421, "_bitap_lay")
    routes(eb_dense, "dense", "dense", "bench needles, dense control")
    h.zero_counts()
    sb, s_miss, s_absent = (staged(e, [h.data], f"bench, {lbl}")[0] for e, lbl in (
        (eb, "3 needles"), (e_miss, "miss needles"), (e_absent, "absent needle")))
    check(not any(h.read_counts().values()), "mesh staging launched a kernel")
    s = h.searcher
    want = {"count_matches": s.count_matches(h.staged),
            "contains_any hit": s.contains_any(h.staged),
            "contains_any miss": h.miss.contains_any(h.staged_miss),
            "contains_all true": s.contains_all(h.staged),
            "contains_all false": h.absent.contains_all(h.staged_absent),
            "all_matches_arrays": s.all_matches_arrays(h.staged)}
    check(want["contains_any hit"] and not want["contains_any miss"] and want["contains_all true"]
          and not want["contains_all false"], f"single-device bench answers: {want}")
    who, ctrl = "mesh (4,2,1)", "mesh dense control"
    drive([
        ("count_matches", who, lambda: eb.count(sb), {"bitap_count": N}),
        ("count_matches", ctrl, lambda: eb_dense.count(sb), {"dense_count": N}),
        ("contains_any hit", who, lambda: eb.contains_any(sb), {"bitap_contains": N}),
        ("contains_any hit", ctrl, lambda: eb_dense.contains_any(sb), {"dense_contains": N}),
        ("contains_any miss", who, lambda: e_miss.contains_any(s_miss), {"bitap_contains": N}),
        ("contains_any miss", ctrl, lambda: e_miss_dense.contains_any(s_miss),
         {"dense_contains": N}),
        ("contains_all true", who, lambda: eb.contains_all(sb), {"matchbits": N}),
        ("contains_all false", who, lambda: e_absent.contains_all(s_absent), {"matchbits": N}),
        ("all_matches_arrays", who, lambda: eb.matches_arrays(sb), {"matchbits": N}),
    ], want)

    # -- IgnoreCase on (4,2,1): the trap parts of S2 and S3, the recovery ------
    eci, e_miss_ci = h.s_ci.distributed(m421), h.miss_ci.distributed(m421)
    lay = eci._bitap_lay
    check(lay is not None and lay.ci and lay.has_trap and eci.machine.composed_ci,
          "mesh IgnoreCase: not the byte-class bitap with a trap")
    few, many = h.trap_hays["few"], h.trap_hays["many"]
    h.zero_counts()
    s_ci, s_few, s_many = staged(eci, [h.data_ci, few[0], many[0]], "IgnoreCase bench")
    s_miss_many = staged(e_miss_ci, [many[0]], "IgnoreCase miss needles")[0]
    for sst, label, route in ((s_few, "few", "host recount"), (s_many, "many", "dense fallback")):
        trap = eci.stream_counts(sst)[1]
        took = "host recount" if eci._trapped_stream_idx(sst, trap) is not None else "dense fallback"
        check(took == route, f"mesh trap corpus ({label}): took the {took}")
        print(f"mesh IgnoreCase trap corpus ({label}): {int((trap != 0).sum())} trapped streams "
              f"-> {took}", flush=True)
    sc = h.s_ci
    want_ci = {"count_matches": sc.count_matches(h.staged_ci),
               "contains_any": sc.contains_any(h.staged_ci),
               "count_matches, TSHİRT in 100 streams": sc.count_matches(few[1]),
               "contains_any, TSHİRT in 100 streams": sc.contains_any(few[1]),
               "count_matches, TSHİRT in 1,000 streams": sc.count_matches(many[1]),
               "contains_any miss, TSHİRT in 1,000": h.miss_ci.contains_any(many[0])}
    check(not want_ci["contains_any miss, TSHİRT in 1,000"], "miss needles hit the trap corpus")
    trap_count, trap_contains = {"bitap_count_trap": N}, {"bitap_contains_trap": N}
    drive([
        ("count_matches", who, lambda: eci.count(s_ci), trap_count),
        ("contains_any", who, lambda: eci.contains_any(s_ci), trap_contains),
        ("count_matches, TSHİRT in 100 streams", who, lambda: eci.count(s_few), trap_count),
        ("contains_any, TSHİRT in 100 streams", who, lambda: eci.contains_any(s_few),
         trap_contains),
        ("count_matches, TSHİRT in 1,000 streams", who, lambda: eci.count(s_many),
         {**trap_count, "dense_count": N}),
        ("contains_any miss, TSHİRT in 1,000", who, lambda: e_miss_ci.contains_any(s_miss_many),
         {**trap_contains, "dense_contains": N}),
    ], want_ci)

    # -- 30 random needles on (2,2,2): comb16 count (S5) and sticky (S4) --------
    n30 = random_needles(3, 30)
    s30 = Searcher.build(CASE_SENSITIVE, n30)
    data30 = np.frombuffer(synth_corpus(n30, h.corpus_bytes, hit_fraction=0.01, seed=19),
                           np.uint8)
    e30 = s30.distributed(m222)
    routes(e30, "comb16", "comb16", "30 needles")
    e30_dense = dense_steps(s30.automaton, m222, "_c16g")
    routes(e30_dense, "dense", "dense", "30 needles, dense control")
    h.zero_counts()
    s30m = staged(e30, [data30], "30 needles")[0]
    st30 = s30.stage(data30)
    want30 = {"count_matches": s30.count_matches(st30), "contains_any": s30.contains_any(st30),
              "all_matches_arrays": s30.all_matches_arrays(st30)}
    check(want30["count_matches"] > 0, "30 needles: no match")
    who, ctrl = "mesh (2,2,2)", "mesh dense control"
    drive([
        ("count_matches", who, lambda: e30.count(s30m), {"comb16_count_grouped": N}),
        ("count_matches", ctrl, lambda: e30_dense.count(s30m), {"dense_count": N}),
        ("contains_any", who, lambda: e30.contains_any(s30m), {"comb16_contains_base": N}),
        ("contains_any", ctrl, lambda: e30_dense.contains_any(s30m), {"dense_contains": N}),
        ("all_matches_arrays", who, lambda: e30.matches_arrays(s30m), {"matchbits": N}),
    ], want30)

    # -- config 2 on (2,1,4): S5, S4 to vend, S8, and the states route (S7) ----
    ec2 = h.s100.distributed(m214)
    routes(ec2, "comb16", "comb16", "config 2")
    h.zero_counts()
    sc2, sff, s16 = staged(ec2, [h.data2, h.clean, h.data2[:MESH_STATES_BYTES]], "config 2")
    d16 = h.data2[:MESH_STATES_BYTES]
    want2 = {"count_matches": h.s100.count_matches(h.st2["config 2"]),
             "contains_any": h.s100.contains_any(h.st2["config 2"]),
             "contains_any fire-free": h.s100.contains_any(h.st2["fire-free"]),
             "all_matches_arrays": h.s100.all_matches_arrays(h.st2["config 2"]),
             "all_matches_arrays, 16 MiB": h.s100.all_matches_arrays(h.s100.stage(d16))}
    check(want2["contains_any"] and not want2["contains_any fire-free"],
          "single-device config 2 answers")
    bare16 = dataclasses.replace(s16, data_np=None)  # no host corpus: the states route
    who = "mesh (2,1,4)"
    drive([
        ("count_matches", who, lambda: ec2.count(sc2), {"comb16_count_grouped": N}),
        ("contains_any", who, lambda: ec2.contains_any(sc2), {"comb16_contains_base": N}),
        ("contains_any fire-free", who, lambda: ec2.contains_any(sff),
         {"comb16_contains_base": N}),
        ("all_matches_arrays", who, lambda: ec2.matches_arrays(sc2), {"matchbits": N}),
        ("all_matches_arrays, 16 MiB", who, lambda: ec2.matches_arrays(s16), {"matchbits": N}),
        ("all_matches_arrays, 16 MiB", who + " states", lambda: ec2.matches_arrays(bare16),
         {"dense_states": N}),
    ], want2)

    # -- a one-rank NCCL group around one (4,2,1) count ----------------------
    reduced = []
    real_all_reduce = torch.distributed.all_reduce

    def spy(t, *a, **kw):
        reduced.append((t.device.type, str(t.dtype)))
        return real_all_reduce(t, *a, **kw)

    with tempfile.TemporaryDirectory() as tmp:
        world = init_distributed("file://" + os.path.join(tmp, "rendezvous"), world_size=1,
                                 rank=0)
        try:
            en = h.searcher.distributed(make_mesh([dev] * 8, data=4, seq=2))
            with mock.patch.object(torch.distributed, "all_reduce", spy):
                h.zero_counts()
                t0 = time.perf_counter()
                n = en.count(sb)
                wall = time.perf_counter() - t0
                used = {k: v for k, v in h.read_counts().items() if v}
            backend = torch.distributed.get_backend()
        finally:
            torch.distributed.destroy_process_group()
    check(world == 1 and n == want["count_matches"], f"NCCL group count {n}")
    check(reduced == [(dev.type, "torch.int64")], f"the count reduced {reduced}")
    check(used == {"bitap_count": N}, f"NCCL group count launched {used}")
    h.tally(main, used)
    print(f"op count_matches mesh (4,2,1), one-rank group {backend!r} {wall * 1e3:10.3f} ms wall "
          f"-> {n}; all_reduce of {reduced} ({card})", flush=True)

    for name in MESH_SITES:
        check(main.get(name, 0) > 0, f"{name} ({MESH_SITES[name][0]}) was not launched by the "
              "mesh operations")

    # -- each site's kernel against its plain version on shard 0, timed -------
    def live_bytes(eng, sst):
        i, _, d = eng.shards()[0]
        return int(sst.blocks[(i, d)].vend.clamp(max=sst.plan.time_len).long().sum())

    sites = {}
    for name, eng, sst, step, what, words in (
            ("dense_count", eb_dense, sb, "count", "bench needles", 1),
            ("bitap_count", eb, sb, "count", "bench needles", eb._bitap_lay.n_words),
            ("bitap_count_trap", eci, s_ci, "count", "IgnoreCase bench, embedded trap",
             len(lay.all_words())),
            ("bitap_contains", e_miss, s_miss, "sticky", "miss needles: full scan",
             e_miss._bitap_lay.n_words),
            ("bitap_contains_trap", e_miss_ci, s_miss_many, "sticky",
             "IgnoreCase miss needles: full scan", len(e_miss_ci._bitap_lay.all_words())),
            ("comb16_contains_base", ec2, sff, "sticky", "config 2, fire-free: full scan", 1),
            ("comb16_count_grouped", ec2, sc2, "count", "config 2", 1),
            ("dense_contains", e_miss_dense, s_miss, "sticky", "miss needles: full scan", 1),
            ("dense_states", ec2, s16, "states", "config 2, 16 MiB", 1),
            ("matchbits", eb, sb, "bits", "bench needles, dense step", 1)):
        i, g, d = eng.shards()[0]
        kernel, args, kw = eng.shard_call(step, sst, i, g, d)
        check(kernel.__name__ == name.replace("_trap", ""), f"{name}: shard 0 runs {kernel}")
        plain = PLAIN[kernel]
        k, p = kernel(*args, **kw), plain(*args, **kw)
        for a, b in zip(k if isinstance(k, tuple) else (k,), p if isinstance(p, tuple) else (p,)):
            h.same(name, a, b, f"mesh {what}, shard 0")
        T, SL = sst.plan.time_len, sst.plan.n_streams // eng.n_stream_shards
        if step in ("states", "bits"):
            sbytes, ops = T * SL, T * SL
            obytes = 4 * T * SL if step == "states" else 4 * SL + T // 32 * SL * 4
        else:
            sbytes = live_bytes(eng, sst)
            ops = sbytes * words
            obytes = 4 * SL * (2 if name.endswith("_trap") else 1)
        ms = h.timed(lambda: kernel(*args, **kw), KERNEL_RUNS)
        plain_ms = h.timed(lambda: plain(*args, **kw), PLAIN_RUNS)
        bms, by = h.bound(sbytes, obytes + h.table_bytes(args), ops)
        site, line = MESH_SITES[name]
        sites[name] = {"site": site, "replaces": f"alfred_margaret_tpu/parallel/shard.py:{line}",
                       "what": what, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                       "bound_by": by, "shard": [T, SL]}
        if name == "comb16_count_grouped":  # S5: B9's design for one group
            sites[name]["design"] = comb16_grouped_design(args[0], args[3], args[4]).as_dict()
        if name == "comb16_contains_base":  # S4: B11's one-group design
            sites[name]["design"] = comb16_grouped_design(args[0], args[2], args[3]).as_dict()
        if name == "matchbits":  # S8: B6's dense step on the shard's streams
            sites[name]["design"] = matchbits_design(args[0], *args[3:], **kw).as_dict()
        if name == "dense_count":  # S1: B1's segments on the shard's streams
            sites[name]["design"] = dense_count_design(args[0], args[2], **kw).as_dict()
        if name.startswith("bitap_count"):  # S2
            sites[name]["design"] = bitap_count_design(args[0], args[1], args[5], **kw).as_dict()
        if name.startswith("bitap_contains"):  # S3
            sites[name]["design"] = bitap_contains_design(args[0], args[1], **kw).as_dict()
        if name == "dense_contains":  # S6: B3's segments on the shard's streams
            sites[name]["design"] = design_of(dense_contains_design(args[0], args[2], **kw),
                                              dense_bits_smem_bytes(args[2].numel()))
        if name == "dense_states":  # S7: B5's segments on the shard's streams
            sites[name]["design"] = design_of(dense_states_design(args[0], args[2], **kw),
                                              dense_bits_smem_bytes(args[2].numel()))
        print(f"time mesh {site} {name:22s} {what:36s} {ms:10.4f} ms per shard launch "
              f"[T, S_local] = [{T}, {SL}], plain {plain_ms:.1f} ms, bound {bms:.4f} ms by {by} "
              f"({ms / bms:.1f}x; {sites[name].get('design', '')}; {card})", flush=True)
    print(f"mesh: every answer == the single-device Searcher; launches {main}, "
          f"control {control}", flush=True)
    return main, control, sites


def api_phase(h):
    """The reference's other operations on the card at ``CORPUS_BYTES``:
    ``Replacer.run`` on config 4's pairs (the batched splice), on a cascading
    set (the incremental loop), on config 2's needles (comb16) and under
    IgnoreCase (composed on a staging, the lowering fallback one-shot, and
    both on one 1 MiB slice against the python Replacer's lowering path);
    ``Splitter`` case-sensitively and under IgnoreCase;
    ``Searcher.adopt_staged`` of the bench staging (reused by the bitap set,
    restaged by the composed IgnoreCase machine) and of a staging of a corpus
    that holds every tier's needles into every tier; and the Boyer-Moore
    searchers' existence queries, which take the AC route on the card.  Every
    output is held against the reference's semantics (a sequential
    ``bytes.replace``, ``bytes.split``) and the port's host C++ engine, and
    every adopted corpus holds matches.
    ``h`` carries ``main``'s helpers, searchers and corpora.  Returns the
    main-path launches."""
    import torch

    from alfred_margaret_tpu_torch import (
        CASE_SENSITIVE, IGNORE_CASE, Replacer, Searcher, Splitter)
    from alfred_margaret_tpu_torch import boyer_moore as bm
    from alfred_margaret_tpu_torch import boyer_moore_ci as bmci
    from alfred_margaret_tpu_torch import replacer as trep
    from alfred_margaret_tpu_torch.bench.dataformat import synth_corpus
    from alfred_margaret_tpu_torch.engine import MatchEngine
    from alfred_margaret_tpu_torch.native.cpp_engine import CppAcEngine
    from alfred_margaret_tpu_torch.utils import utf8

    card, main = h.card, {}

    # -- the host library: without it the splices fall back to Python loops --
    lib = utf8._native_lib()
    check(lib is not None, "the host C++ library did not load: the Replacer would run its "
          "Python fallbacks")
    missing = [s for s in REPLACER_SYMBOLS if not hasattr(lib, s)]
    check(not missing, f"the host C++ library lacks {missing}")
    print(f"api: host C++ library {lib._name} exports {', '.join(REPLACER_SYMBOLS)}", flush=True)

    def launched(label, fn, expect=None):
        """``fn()`` with the launches it made and its wall; the launches
        join the main path's and must include ``expect``."""
        h.zero_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        used = {k: v for k, v in h.read_counts().items() if v}
        h.tally(main, used)
        check(expect is None or used.get(expect, 0) > 0,
              f"{label}: {expect} was not launched ({used})")
        return out, wall, used

    class Passes:
        """Counts of the Replacer's pass paths during one run: the batched
        splice, the passes that spliced, the window rescans and the scans of
        ``engine`` (the first, and full rescans after it)."""

        def __init__(self, engine):
            self.engine, self.n = engine, dict(batched=0, passes=0, windows=0, scans=0)

        def __enter__(self):
            n, eng = self.n, self.engine
            batched, windows = trep.Replacer._run_batched, trep.Replacer._scan_windows
            splice, splice_full, matches = trep._splice_owned, trep._splice, MatchEngine.matches

            def count(key, fn):
                def wrapped(*a, **k):
                    n[key] += 1
                    return fn(*a, **k)
                return wrapped

            def scans(me, text, case):
                n["scans"] += me is eng
                return matches(me, text, case)

            self.patches = [mock.patch.object(trep.Replacer, "_run_batched",
                                              count("batched", batched)),
                            mock.patch.object(trep.Replacer, "_scan_windows",
                                              count("windows", windows)),
                            mock.patch.object(trep, "_splice_owned", count("passes", splice)),
                            mock.patch.object(trep, "_splice", count("passes", splice_full)),
                            mock.patch.object(MatchEngine, "matches", scans)]
            for p in self.patches:
                p.start()
            return self.n

        def __exit__(self, *exc):
            for p in self.patches:
                p.stop()

    def sequential(pairs, data: bytes) -> bytes:
        """The reference's semantics: ``replace`` per needle in build order."""
        for n, r in pairs:
            data = data.replace(n.encode(), r.encode())
        return data

    def replacer_check(label, case, pairs, corpus, staged_too=True, one_shot=True, gates=()):
        """Run ``Replacer.build(case, pairs)`` on the card, one-shot and on a
        staged handle, against the host C++ Replacer and ``gates``
        (``(name, expected bytes)``); returns the pass counts of the last run."""
        r = Replacer.build(case, pairs)
        check(r.searcher.device == h.dev, f"{label}: Replacer defaulted to {r.searcher.device}")
        t0 = time.perf_counter()
        want = Replacer.build(case, pairs, engine="cpp").run(corpus)
        cpp_s = time.perf_counter() - t0
        walls, outs = [], []
        if one_shot:
            with Passes(r.searcher._engine) as n:
                out, wall, used = launched(label, lambda: r.run(corpus))
            outs.append(("one-shot", out, wall, used, dict(n)))
        if staged_too:
            t0 = time.perf_counter()
            st = r.searcher.stage(corpus)
            torch.cuda.synchronize()
            stage_s = time.perf_counter() - t0
            with Passes(r.searcher._engine) as n:
                out, wall, used = launched(label, lambda: r.run(st))
            outs.append((f"staged (stage {stage_s:.3f} s)", out, wall, used, dict(n)))
        for how, out, wall, used, n in outs:
            check(out == want, f"{label} {how}: output != the host C++ Replacer's")
            for name, g in gates:
                check(out == g, f"{label} {how}: output != {name}")
            print(f"api replacer {label} {how}: {len(corpus)} -> {len(out)} bytes in "
                  f"{wall:.3f} s wall (host C++ Replacer {cpp_s:.3f} s); passes {n['passes']}, "
                  f"batched {n['batched']}, window rescans {n['windows']}, device scans "
                  f"{n['scans']} (full rescans {max(0, n['scans'] - 1)}); launches {used} "
                  f"({card})", flush=True)
            walls.append(n)
        check(want != corpus, f"{label}: nothing was replaced")
        return walls[-1]

    # -- Replacer, config 4: the batched splice ---------------------------------
    corpus4 = synth_corpus(["tshirt", "shirts", "shorts"], h.corpus_bytes, hit_fraction=0.01,
                           seed=9)
    t0 = time.perf_counter()
    seq4 = sequential(CONFIG4_PAIRS, corpus4)
    print(f"api replacer config 4: sequential bytes.replace {time.perf_counter() - t0:.3f} s",
          flush=True)
    n = replacer_check("config 4", CASE_SENSITIVE, CONFIG4_PAIRS, corpus4,
                       gates=[("sequential bytes.replace", seq4)])
    check(n["batched"] == 1 and n["windows"] == 0, f"config 4 did not take the batched path: {n}")
    check(main.get("matchbits", 0) > 0, "config 4: B6 was not launched")

    # -- Replacer, a cascading set: the incremental loop ------------------------
    n = replacer_check("cascade", CASE_SENSITIVE, CASCADE_PAIRS, corpus4,
                       gates=[("sequential bytes.replace", sequential(CASCADE_PAIRS, corpus4))])
    check(n["batched"] == 0 and n["passes"] == 3 and n["windows"] + n["scans"] > 1,
          f"the cascading set did not take the incremental path: {n}")
    print(f"api replacer cascade: full device rescan {'taken' if n['scans'] > 1 else 'not taken'}"
          f" (windows over half the text)", flush=True)

    # -- Replacer, config 2: comb16 (B13) ---------------------------------------
    pairs2 = [(x, x.upper()) for x in h.c2]
    corpus2 = h.data2[:API_CONFIG2_BYTES].tobytes()
    t0 = time.perf_counter()
    seq2 = sequential(pairs2, corpus2)
    print(f"api replacer config 2: sequential bytes.replace {time.perf_counter() - t0:.3f} s",
          flush=True)
    before = main.get("matchbits_comb16", 0)
    replacer_check("config 2", CASE_SENSITIVE, pairs2, corpus2, one_shot=False,
                   gates=[("sequential bytes.replace", seq2)])
    check(main.get("matchbits_comb16", 0) > before, "config 2: B13 was not launched")

    # -- Replacer, IgnoreCase ----------------------------------------------------
    data_ci = h.data_ci.tobytes()
    n = replacer_check("IgnoreCase config 4", IGNORE_CASE, CONFIG4_PAIRS, data_ci,
                       one_shot=False)
    check(n["batched"] + n["windows"] > 0 or n["passes"] > 0, "IgnoreCase: no pass ran")
    hay = data_ci[: 1 << 20]
    r_low = Replacer.build(IGNORE_CASE, CONFIG4_PAIRS)  # never staged: no composed engine
    with Passes(r_low.searcher._engine) as n:
        out, wall, used = launched("IgnoreCase lowering", lambda: r_low.run(hay), "matchbits")
    check(r_low.searcher._engine._ci is False, "a 1 MiB one-shot IgnoreCase run composed")
    t0 = time.perf_counter()
    want_py = Replacer.build(IGNORE_CASE, CONFIG4_PAIRS, engine="python").run(hay)
    py_s = time.perf_counter() - t0
    check(out == want_py == Replacer.build(IGNORE_CASE, CONFIG4_PAIRS, engine="cpp").run(hay),
          "IgnoreCase lowering: output != the python and host C++ Replacers'")
    check(n["scans"] == n["passes"] + 1 or n["scans"] == n["passes"],
          f"IgnoreCase lowering: not the full-rescan loop: {n}")
    print(f"api replacer IgnoreCase lowering fallback: {len(hay)} bytes in {wall:.3f} s wall "
          f"(python Replacer {py_s:.3f} s); passes {n['passes']}, device scans {n['scans']}; "
          f"launches {used} ({card})", flush=True)
    # The composed path on the same 1 MiB, staged, against the python
    # Replacer's lowering path: it shares no composed DFA, start recovery or
    # window rescan with the composed run.
    for label, pairs in (("config 4", CONFIG4_PAIRS), ("cascade", CASCADE_PAIRS)):
        r_comp = Replacer.build(IGNORE_CASE, pairs)
        st = r_comp.searcher.stage(hay)
        check(st.composed and st.device is not None, f"IgnoreCase {label}: 1 MiB not composed")
        with Passes(r_comp.searcher._engine) as n:
            out, wall, used = launched(f"IgnoreCase composed {label}", lambda: r_comp.run(st),
                                       "matchbits")
        want = (want_py if pairs is CONFIG4_PAIRS
                else Replacer.build(IGNORE_CASE, pairs, engine="python").run(hay))
        check(out == want, f"IgnoreCase composed {label}: output != the python Replacer's "
              f"lowering path")
        check(want != hay, f"IgnoreCase composed {label}: nothing was replaced")
        print(f"api replacer IgnoreCase composed {label}: {len(hay)} bytes staged in {wall:.3f} s "
              f"wall == python Replacer (lowering); passes {n['passes']}, batched "
              f"{n['batched']}, window rescans {n['windows']}, device scans {n['scans']}; "
              f"launches {used} ({card})", flush=True)
    r600 = Replacer.build(IGNORE_CASE, [(x, x.upper()) for x in h.n600])
    lowered = r600.searcher.stage(b"KILO " * 200)
    check(lowered.lowered is not None and not lowered.composed,
          "config 5's 600 needles: the staging is not lowered")
    try:
        r600.run(lowered)
        check(False, "a lowered staging did not raise in Replacer.run")
    except ValueError as e:
        print(f"api replacer: a lowered staging raises ValueError ({e})", flush=True)

    # -- Splitter ------------------------------------------------------------------
    sp = Splitter.build(b"shorts")
    parts, wall, used = launched("split", lambda: sp.split(corpus4), "matchbits")
    t0 = time.perf_counter()
    want = corpus4.split(b"shorts")
    py_s = time.perf_counter() - t0
    check(parts == want, "split != bytes.split")
    print(f"api splitter split: {len(parts)} fragments in {wall:.3f} s wall (bytes.split "
          f"{py_s:.3f} s); launches {used} ({card})", flush=True)
    parts, wall, used = launched("split_ignore_case", lambda: sp.split_ignore_case(data_ci),
                                 "matchbits")
    t0 = time.perf_counter()
    want = Splitter.build(b"shorts", engine="cpp").split_ignore_case(data_ci)
    cpp_s = time.perf_counter() - t0
    check(parts == want, "split_ignore_case != the host C++ Splitter's")
    check(len(parts) == len(h.data.tobytes().split(b"shorts")),
          "split_ignore_case: fragments != those of the unscrambled corpus")
    print(f"api splitter split_ignore_case: {len(parts)} fragments in {wall:.3f} s wall (host "
          f"C++ Splitter {cpp_s:.3f} s); launches {used} ({card})", flush=True)

    # -- adopt_staged: a needle-set swap over one staging -------------------------
    def adopt_check(label, s, st0, data, expect_reuse):
        """Adopt ``st0`` into ``s``; its count and ``contains_any`` against
        the host C++ engine, with at least one match."""
        t0 = time.perf_counter()
        st = s.adopt_staged(st0)
        torch.cuda.synchronize()
        adopt_s = time.perf_counter() - t0
        m = s._engine._ci.machine if st.composed else s.automaton
        need = max(0, m.max_needle_bytes - 1)
        reused = st.device is st0.device
        check(reused == (need <= st0.device.plan.overlap) == expect_reuse,
              f"adopt {label}: reused {reused} with overlap {st0.device.plan.overlap}, need {need}")
        if reused:
            check(st.device.streams is st0.device.streams, f"adopt {label}: new streams")
        hc = CppAcEngine(m)
        got, wall, used = launched(f"adopt {label}",
                                   lambda: (s.count_matches(st), s.contains_any(st)))
        want = (hc.count(data), hc.first_hit(data) >= 0)
        check(got == want, f"adopt {label}: {got} != host C++ {want}")
        check(got[0] > 0 and got[1], f"adopt {label}: no match in the adopted corpus")
        print(f"api adopt_staged {label}: {'reused the streams' if reused else 'restaged'} "
              f"(overlap {st0.device.plan.overlap} vs {need}) in {adopt_s:.3f} s; count "
              f"{got[0]}, contains_any {got[1]} == host C++ in {wall:.3f} s; launches {used} "
              f"({card})", flush=True)

    # The bench staging (overlap 5): the bitap set reuses it, the composed
    # IgnoreCase machine needs a longer warm-up and restages.
    print(f"api adopt_staged bench staging: {h.stage_s:.3f} s ({card})", flush=True)
    adopt_check("bitap, bench needles + SHORTS", h.absent, h.staged, h.data, True)
    adopt_check("IgnoreCase, composed", h.s_ci, h.staged, h.data, False)
    # A corpus that holds every tier's needles, staged once with the widest
    # warm-up any of them needs, then swapped into each tier.
    targets = [("dense, 30 needles", h.s30), ("comb16, config 2", h.s100),
               ("comb32, config 5's 300", h.s300), ("grouped, config 5's 1,000", h.s1000),
               ("IgnoreCase, composed", h.s_ci)]
    h.s_ci._engine._composed(IGNORE_CASE)
    widest = max(max(0, (s._engine._ci.machine if s._engine._ci else s.automaton)
                     .max_needle_bytes - 1) for _, s in targets)
    union = NEEDLES + h.n30 + h.c2 + h.n1000
    data_u = np.frombuffer(synth_corpus(union, h.corpus_bytes, hit_fraction=0.01, seed=23),
                           np.uint8)
    wide = Searcher.build(CASE_SENSITIVE, NEEDLES + ["q" * (widest + 1)])
    t0 = time.perf_counter()
    st_u = wide.stage(data_u)
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t0
    check(st_u.device.plan.overlap == widest, f"union staging overlap {st_u.device.plan.overlap}")
    print(f"api adopt_staged union staging: {len(union)} needles' corpus, overlap {widest}, "
          f"{stage_s:.3f} s ({card})", flush=True)
    for label, s in targets:
        adopt_check(label + ", union corpus", s, st_u, data_u, True)

    # -- Boyer-Moore: existence over a large haystack takes the AC route -------------
    for label, mod, absent_needle, hay in (("boyer_moore", bm, "SHORTS", h.data.tobytes()),
                                           ("boyer_moore_ci", bmci, "tshirt9", data_ci)):
        for needles, op, expect in ((NEEDLES + [absent_needle], "contains_any", True),
                                    (NEEDLES, "contains_all", True),
                                    (NEEDLES + [absent_needle], "contains_all", False)):
            srch = mod.Searcher.build(needles)
            got, wall, used = launched(f"{label} {op}", lambda: getattr(srch, op)(hay))
            check(bool(used), f"{label} {op}: the AC route launched no kernel")
            check(srch._ac_searcher().device == h.dev, f"{label}: the AC route left the card")
            want = getattr(mod.Searcher.build(needles, engine="cpp", device="cpu"), op)(hay)
            check(got is want is expect, f"{label} {op}: {got}, host C++ {want}, want {expect}")
            print(f"api {label} {op} over {len(needles)} needles: {got} == host C++ over "
                  f"{len(hay)} bytes in {wall:.3f} s wall; launches {used} ({card})", flush=True)
    return main


#: The streamed corpus: 16 chunks of the default 128 MiB and a ragged one.
STREAM_BYTES = (2 << 30) + 12345
#: The other tiers' streamed corpora: 4 chunks.
STREAM_TIER_BYTES = 512 << 20
#: The chunk sizes timed for the streamed count, MiB; the first is the
#: default (``AMT_STREAM_CHUNK_MB``), the other streamed answers' chunk.
STREAM_GRID_MB = (128, 32, 64, 256, 512)
#: The chunk sizes the bench needles' answers are checked at again, MiB (96
#: does not divide the corpus).
STREAM_CHECK_MB = (64, 96)
#: ``TSHİRT``: a needle whose İ fires the composed machine's trap track.
TRAP_WORD = "TSHİRT".encode()


def stream_phase(h):
    """Streaming past the device budget (``2 * AMT_STREAM_CHUNK_MB``) on the
    card: ``MatchEngine`` scans a haystack over the budget chunk by chunk
    (``ops/streaming.py``), each chunk staged on the card in turn.

    The bench needles over a memmap of ``STREAM_BYTES`` (each 128 MiB of
    ``synth_corpus`` its own seed): ``count_matches`` (B2; B1 on the dense
    engine as the control), ``contains_any`` of a hit and of the miss needles
    (B4, the miss a full scan; B3 the control's) and ``all_matches_arrays``
    (B6), each equal to
    the host C++ engine over the whole file, count and matches to the corpus
    staged whole on the card, and all again at chunks of 64 and 96 MiB; the
    other tiers over ``STREAM_TIER_BYTES`` (config 2, config 5's first 300
    and first 1,000, composed IgnoreCase with ``TSHİRT`` across the cuts,
    the lowering path on config 5's first 600); ``Searcher.stage`` over the
    budget (no device staging; its scans stream); one count under
    ``AMT_VALIDATE=1``; the mesh (4,2,1) streaming 3 chunks; and on the
    card's host the prefilter of the ``cpp`` backend (config 5's first
    2,000 needles) and the host bitap oracle.  Every chunk of every streamed
    scan must be staged on the card, and every operation must launch its
    kernels.  Prints the walls beside the card (streamed count per GiB, the
    whole-corpus staging and count, the chunk-size grid, per-chunk staging
    against the kernel).  ``h`` carries ``main``'s helpers and searchers.
    Returns (main-path launches, control launches)."""
    import tempfile

    import torch

    from alfred_margaret_tpu_torch import CASE_SENSITIVE, IGNORE_CASE, Searcher
    from alfred_margaret_tpu_torch.bench.configs import config2_needles, config5_needles
    from alfred_margaret_tpu_torch.bench.dataformat import synth_corpus
    from alfred_margaret_tpu_torch.native import build as native_build
    from alfred_margaret_tpu_torch.native.cpp_engine import CppAcEngine, CppBitapEngine
    from alfred_margaret_tpu_torch.native.prefilter import PrefilterEngine
    from alfred_margaret_tpu_torch.ops.streaming import StreamingScanner
    from alfred_margaret_tpu_torch.parallel import make_mesh
    from alfred_margaret_tpu_torch.utils import config, utf8

    card, dev, main, control = h.card, h.dev, {}, {}
    t_phase = time.perf_counter()
    check(config.DEFAULT.stream_chunk_mb == STREAM_GRID_MB[0], "AMT_STREAM_CHUNK_MB is set: "
          "the phase measures the default chunk")
    CHUNK = config.DEFAULT.stream_chunk_mb << 20
    lib = native_build.load()
    for sym in ("am_prefilter_count", "am_prefilter_first", "am_bitap_count_mt",
                "am_bitap_first"):
        check(hasattr(lib, sym), f"the host C++ library lacks {sym}")

    def chunk_mb(mb, **kw):
        """``config.DEFAULT`` with chunks of ``mb`` MiB (and ``kw``)."""
        return mock.patch.object(config, "DEFAULT", dataclasses.replace(
            config.DEFAULT, stream_chunk_mb=mb, **kw))

    class Chunks:
        """Spies on ``eng.stage`` while open: each staged chunk's length and
        device, and the staging's wall (synchronised)."""

        def __init__(self, eng):
            self.eng, self.seen = eng, []

        def __enter__(self):
            stage = self.eng.stage

            def spy(x):
                t0 = time.perf_counter()
                st = stage(x)
                torch.cuda.synchronize()
                blocks = getattr(st, "blocks", None)
                devs = ({d.type for _, d in blocks} if blocks is not None
                        else {st.streams.device.type})
                self.seen.append((len(x), devs, time.perf_counter() - t0))
                return st

            self.patch = mock.patch.object(self.eng, "stage", spy)
            self.patch.start()
            return self

        def __exit__(self, *exc):
            self.patch.stop()

        def check(self, label, n, chunk, expect=None):
            lens = [x for x, _, _ in self.seen]
            n_chunks = -(-n // chunk)
            check(all(d == {dev.type} for _, d, _ in self.seen),
                  f"{label}: a chunk was staged off the card")
            check(lens and max(lens) <= chunk + 64,
                  f"{label}: staged {max(lens or [0])} bytes at once (chunk {chunk})")
            check(expect is None or len(lens) == expect * n_chunks,
                  f"{label}: {len(lens)} chunks staged, expected {expect} x {n_chunks}")
            self.seen.clear()
            return len(lens)

    def run(label, eng, fn, want, expect, into=main, n=None, chunk=CHUNK, passes=None):
        """``fn()`` with the kernel launch counts set to 0 just before and read
        just after, every chunk watched: its answer must equal ``want``, and
        it must launch every kernel of ``expect``."""
        with Chunks(eng) as spy:
            h.zero_counts()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            used = {k: v for k, v in h.read_counts().items() if v}
        h.tally(into, used)
        if isinstance(want, tuple):
            ok = np.array_equal(out[0], want[0]) and np.array_equal(out[1], want[1])
            shown = f"{len(out[0])} matches"
        else:
            ok, shown = out == want, str(out)
        check(ok, f"stream {label}: {shown} != {want if not isinstance(want, tuple) else len(want[0])}")
        missing = [k for k in expect if not used.get(k)]
        check(used and not missing, f"stream {label}: {missing} not launched ({used})")
        k = spy.check(label, n, chunk, passes)
        print(f"stream {label:44s} {wall * 1e3:10.1f} ms wall, {k} chunks -> {shown} "
              f"launches {used} ({card})", flush=True)
        return wall

    # -- the bench needles over 2 GiB + 12,345 bytes, from a memmap -------------
    tmp = tempfile.TemporaryDirectory(prefix="amt_stream_")
    try:
        t0 = time.perf_counter()
        path = os.path.join(tmp.name, "corpus.bin")
        with open(path, "wb") as f:
            for k in range(-(-STREAM_BYTES // CHUNK)):
                f.write(synth_corpus(NEEDLES, min(CHUNK, STREAM_BYTES - k * CHUNK),
                                     hit_fraction=0.01, seed=100 + k))
        mm = np.memmap(path, dtype=np.uint8, mode="r")
        check(len(mm) == STREAM_BYTES, "the streamed corpus's length")
        write_s = time.perf_counter() - t0
        s, eng = h.searcher, h.searcher._engine.device_engine()
        dense = h.dense_searcher
        host = CppAcEngine(s.automaton)
        t0 = time.perf_counter()
        want = {"count": host.count(mm), "hit": host.first_hit(mm) >= 0,
                "miss": CppAcEngine(h.miss.automaton).first_hit(mm) >= 0,
                "matches": host.matches_arrays(mm)}
        host_s = time.perf_counter() - t0
        check(want["count"] > 0 and want["hit"] and not want["miss"]
              and len(want["matches"][0]) == want["count"], f"host C++ answers: {want['count']}")
        print(f"stream corpus: {STREAM_BYTES} bytes ({-(-STREAM_BYTES // CHUNK)} chunks of "
              f"{CHUNK}) written in {write_s:.1f} s, memmapped; host C++ count, first hits and "
              f"matches over the file {host_s:.1f} s -> {want['count']} matches", flush=True)
        miss_eng = h.miss._engine.device_engine()
        dense_eng = dense._engine.device_engine()
        miss_dense_eng = h.miss_dense._engine.device_engine()
        walls = {}
        for mb in (STREAM_GRID_MB[0],) + STREAM_CHECK_MB:
            chunk = mb << 20
            with chunk_mb(mb):
                n = STREAM_BYTES
                tag = f"{mb} MiB chunks"
                walls[("count", mb)] = run(f"count_matches, {tag}", eng,
                                           lambda: s.count_matches(mm), want["count"],
                                           ["bitap_count"], n=n, chunk=chunk, passes=1)
                run(f"count_matches dense control, {tag}", dense_eng,
                    lambda: dense.count_matches(mm), want["count"], ["dense_count"],
                    into=control, n=n, chunk=chunk, passes=1)
                run(f"contains_any hit, {tag}", eng, lambda: s.contains_any(mm), True,
                    ["bitap_contains"], n=chunk, chunk=chunk, passes=1)
                walls[("miss", mb)] = run(f"contains_any miss, {tag}", miss_eng,
                                          lambda: h.miss.contains_any(mm), False,
                                          ["bitap_contains"], n=n, chunk=chunk, passes=1)
                run(f"contains_any miss dense control, {tag}", miss_dense_eng,
                    lambda: h.miss_dense.contains_any(mm), False, ["dense_contains"],
                    into=control, n=n, chunk=chunk, passes=1)
                walls[("matches", mb)] = run(f"all_matches_arrays, {tag}", eng,
                                             lambda: s.all_matches_arrays(mm), want["matches"],
                                             ["matchbits"], n=n, chunk=chunk, passes=1)

        # The same corpus staged whole on the card (80 GB hold it), one shot.
        t0 = time.perf_counter()
        st_whole = eng.stage(mm)
        torch.cuda.synchronize()
        whole_stage_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        whole_count = eng.count_staged(st_whole)
        whole_count_ms = (time.perf_counter() - t0) * 1e3
        check(whole_count == want["count"], f"whole staging count {whole_count}")
        whole_matches = eng.matches_arrays_staged(st_whole)
        check(all(np.array_equal(a, b) for a, b in zip(whole_matches, want["matches"])),
              "whole staging matches != host C++")
        del st_whole, whole_matches
        torch.cuda.empty_cache()
        print(f"stream whole-corpus staging of {STREAM_BYTES} bytes {whole_stage_s:.3f} s, "
              f"count_staged {whole_count_ms:.3f} ms -> {whole_count} == streamed == host C++; "
              f"matches equal ({card})", flush=True)

        # The chunk-size grid, and one streamed count's chunks: staging against
        # the kernel.
        grid = {}
        for mb in STREAM_GRID_MB:
            with chunk_mb(mb):
                t0 = time.perf_counter()
                got = s.count_matches(mm)
                grid[mb] = time.perf_counter() - t0
            check(got == want["count"], f"count at {mb} MiB chunks: {got}")
        with Chunks(eng) as spy:
            count_staged = type(eng).count_staged
            count_s = []

            def timed_count(st):
                t0 = time.perf_counter()
                out = count_staged(eng, st)
                count_s.append(time.perf_counter() - t0)
                return out

            with mock.patch.object(eng, "count_staged", timed_count):
                check(s.count_matches(mm) == want["count"], "the timed streamed count")
            stage_ms = sorted(t * 1e3 for _, _, t in spy.seen[:-1])  # full chunks
        st1 = eng.stage(mm[:CHUNK])
        kernel_ms = h.timed(lambda: eng.stream_counts(st1), 20)
        del st1
        gib, mb0 = STREAM_BYTES / (1 << 30), STREAM_GRID_MB[0]
        timings = {
            "card": card, "corpus_bytes": STREAM_BYTES, "chunk_bytes": CHUNK,
            "count_s": walls[("count", mb0)], "count_s_per_gib": walls[("count", mb0)] / gib,
            "count_gb_per_s": STREAM_BYTES / walls[("count", mb0)] / 1e9,
            "contains_miss_s": walls[("miss", mb0)],
            "all_matches_arrays_s": walls[("matches", mb0)],
            "whole_stage_s": whole_stage_s, "whole_count_ms": whole_count_ms,
            "whole_stage_and_count_s": whole_stage_s + whole_count_ms / 1e3,
            "grid_count_s": {str(mb): grid[mb] for mb in STREAM_GRID_MB},
            "grid_gb_per_s": {str(mb): STREAM_BYTES / grid[mb] / 1e9 for mb in STREAM_GRID_MB},
            "chunk_stage_ms": {"min": stage_ms[0], "median": stage_ms[len(stage_ms) // 2],
                               "max": stage_ms[-1]},
            "chunk_count_staged_ms_median": sorted(count_s)[len(count_s) // 2] * 1e3,
            "chunk_kernel_ms": kernel_ms,
        }
        print("stream timings " + json.dumps(timings), flush=True)

        # Searcher.stage over the budget: no device staging; its scans stream.
        staged = s.stage(mm)
        check(staged.device is None and len(staged) == STREAM_BYTES,
              "Searcher.stage over the budget staged the corpus on the card")
        run("staged handle count_matches", eng, lambda: s.count_matches(staged), want["count"],
            ["bitap_count"], n=STREAM_BYTES, passes=1)
        run("staged handle contains_any", eng, lambda: s.contains_any(staged), True,
            ["bitap_contains"], n=CHUNK, passes=1)
        with chunk_mb(STREAM_GRID_MB[0], validate=True):
            checked = Searcher(CASE_SENSITIVE, s.needles, machine=s.automaton, device=dev)
            check(checked._engine._validate, "AMT_VALIDATE did not reach the engine")
            checked._engine._device_eng = eng
            run("count_matches AMT_VALIDATE=1", eng, lambda: checked.count_matches(mm),
                want["count"], ["bitap_count"], n=STREAM_BYTES, passes=1)

        # The mesh: eight shards of the card on (4,2,1), 3 chunks.
        mm3 = mm[: 3 * CHUNK]
        dist = s.distributed(make_mesh([dev] * 8, data=4, seq=2))
        dist_miss = h.miss.distributed(make_mesh([dev] * 8, data=4, seq=2))
        sc, sc_miss = (StreamingScanner(d, d.machine, chunk_bytes=CHUNK)
                       for d in (dist, dist_miss))
        want3 = {"count": s.count_matches(mm3), "hit": s.contains_any(mm3),
                 "miss": h.miss.contains_any(mm3), "matches": s.all_matches_arrays(mm3)}
        check(want3["count"] == host.count(mm3), "single-device streamed count of 3 chunks")
        run("mesh (4,2,1) count_matches", dist, lambda: sc.count(mm3), want3["count"],
            ["bitap_count"], n=len(mm3), passes=1)
        run("mesh (4,2,1) contains_any hit", dist, lambda: sc.contains(mm3), want3["hit"],
            ["bitap_contains"], n=CHUNK, passes=1)
        run("mesh (4,2,1) contains_any miss", dist_miss, lambda: sc_miss.contains(mm3),
            want3["miss"], ["bitap_contains"], n=len(mm3), passes=1)
        run("mesh (4,2,1) all_matches_arrays", dist, lambda: sc.matches_arrays(mm3),
            want3["matches"], ["matchbits"], n=len(mm3), passes=1)

        # The host bitap oracle on the bench needles, over the file.
        t0 = time.perf_counter()
        hb = CppBitapEngine(s.automaton)
        hb_count, hb_hit = hb.count(mm), hb.contains(mm)
        check(hb_count == want["count"] and hb_hit is True
              and hb.contains(mm[: 1 << 20]) == (host.first_hit(mm[: 1 << 20]) >= 0),
              f"host bitap oracle {hb_count} != host C++ {want['count']}")
        print(f"stream host bitap oracle: count {hb_count} == host C++ over {STREAM_BYTES} "
              f"bytes in {time.perf_counter() - t0:.3f} s host clock", flush=True)
        del mm, mm3, staged
    finally:
        tmp.cleanup()

    # -- the other tiers over 512 MiB: 4 chunks -----------------------------------
    n = STREAM_TIER_BYTES
    cuts = [k * CHUNK for k in range(1, n // CHUNK)]
    digits = np.frombuffer((DIGITS * (n // len(DIGITS) + 1))[:n], np.uint8)

    def near_end(base, needle):
        """``base`` with ``needle`` written into its last chunk."""
        a = base.copy()
        at = n - CHUNK // 2
        a[at : at + len(needle)] = np.frombuffer(needle, np.uint8)
        return a

    def tier(label, srch, corpus, hit_hay, expect, host_eng=None, lowering=False):
        """count, contains_any on ``corpus`` and on ``hit_hay`` (a needle in the
        last chunk) and all_matches_arrays, streamed, against the host C++
        engine.  On the lowering path the host C++ engine scans the lowered
        bytes, and extraction is left out: lowering 512 MiB with its raw
        coordinates is host work of seconds."""
        e = srch._engine.device_engine() if host_eng is None else host_eng[0]
        hc = CppAcEngine(srch.automaton) if host_eng is None else host_eng[1]

        def scanned(x):
            return utf8.lower_transform(x, need_coords=False).lowered if lowering else x

        w = {"count": hc.count(scanned(corpus)), "any": hc.first_hit(scanned(corpus)) >= 0,
             "hit": hc.first_hit(scanned(hit_hay)) >= 0}
        check(w["count"] > 0 and w["hit"], f"{label}: no match in the tier's corpora")
        ops = [("count_matches", lambda: srch.count_matches(corpus), w["count"]),
               ("contains_any", lambda: srch.contains_any(corpus), w["any"]),
               ("contains_any, a needle in the last chunk", lambda: srch.contains_any(hit_hay),
                w["hit"])]
        if not lowering:
            ops.append(("all_matches_arrays", lambda: srch.all_matches_arrays(corpus),
                        hc.matches_arrays(corpus)))
        for op, fn, ans in ops:
            run(f"{label} {op}", e, fn, ans, expect.get(op, ()), n=n)

    t0 = time.perf_counter()
    c2 = config2_needles()
    data2 = np.frombuffer(synth_corpus(c2, n, hit_fraction=0.01, seed=41), np.uint8)
    tier("config 2", h.s100, data2, near_end(digits, c2[7].encode()), {
        "count_matches": ["comb16_count"], "contains_any": ["filter_contains"],
        "contains_any, a needle in the last chunk": ["filter_contains", "comb16_contains"],
        "all_matches_arrays": ["matchbits_comb16"]})
    del data2
    n300 = config5_needles(300)
    data3 = np.frombuffer(synth_corpus(n300, n, hit_fraction=0.01, seed=43), np.uint8)
    tier("config 5, 300", h.s300, data3, near_end(digits, n300[-1].encode()), {
        "count_matches": ["comb_count"], "contains_any": ["comb_contains"],
        "contains_any, a needle in the last chunk": ["comb_contains"],
        "all_matches_arrays": ["comb_count", "comb_states"]})
    del data3
    data5 = np.frombuffer(synth_corpus(h.n1000[:500], n, hit_fraction=0.01, seed=45), np.uint8)
    # (The 12-word screen may have retired by its strike rule in the
    # grouped path: B11 decides then.)
    tier("config 5, 1,000 grouped", h.s1000, data5, near_end(digits, h.last5), {
        "count_matches": ["screen_count"], "contains_any": ["comb16_contains_grouped"],
        "contains_any, a needle in the last chunk": ["comb16_contains_grouped"],
        "all_matches_arrays": ["comb_states"]})
    del data5
    # Composed IgnoreCase: the scrambled bench corpus, TSHİRT across every cut.
    data_ci = h.scramble(synth_corpus(NEEDLES, n, hit_fraction=0.01, seed=47), 49)
    for c in cuts:
        data_ci[c - 3 : c - 3 + len(TRAP_WORD)] = np.frombuffer(TRAP_WORD, np.uint8)
    ci = h.s_ci._engine._composed(IGNORE_CASE)
    check(ci.device_engine().bitap_tables.trapmask is not None, "IgnoreCase: no trap track")
    miss_ci = h.miss_ci._engine._composed(IGNORE_CASE)
    tier("IgnoreCase composed", h.s_ci, data_ci, near_end(digits, TRAP_WORD), {
        "count_matches": ["bitap_count_trap"], "contains_any": ["bitap_contains_trap"],
        "contains_any, a needle in the last chunk": ["bitap_contains_trap"],
        "all_matches_arrays": ["matchbits"]},
        host_eng=(ci.device_engine(), CppAcEngine(ci.machine)))
    w_miss = CppAcEngine(miss_ci.machine).first_hit(data_ci) >= 0
    run("IgnoreCase composed contains_any miss", miss_ci.device_engine(),
        lambda: h.miss_ci.contains_any(data_ci), w_miss, ["bitap_contains_trap"], n=n, passes=1)
    # The lowering path: config 5's first 600, lowered whole, then streamed.
    data600 = h.scramble(synth_corpus(h.n600, n, hit_fraction=0.01, seed=51), 53)
    for c in cuts:
        data600[c - 5 : c - 5 + len(TRAP_WORD)] = np.frombuffer(TRAP_WORD, np.uint8)
    tier("IgnoreCase lowering, config 5's 600", h.s600, data600,
         near_end(digits, h.n600[-1].upper().encode()),
         {"count_matches": ["screen_count"],
          "contains_any, a needle in the last chunk": ["comb16_contains_grouped"]},
         host_eng=(h.s600._engine.device_engine(), CppAcEngine(h.s600.automaton)),
         lowering=True)
    check(h.s600._engine._ci is None, "config 5's 600 needles composed")
    del data_ci, data600
    print(f"stream tiers over {n} bytes each in {time.perf_counter() - t0:.1f} s", flush=True)

    # -- the prefilter of the cpp backend, on the card's host ----------------------
    t0 = time.perf_counter()
    n2000 = config5_needles(2000)
    m2000 = Searcher.build(CASE_SENSITIVE, n2000, engine="cpp", device=dev).automaton
    pf_walls, answers = {}, {}
    auto = (os.cpu_count() or 1) >= 8  # the automatic rule, with 2,000 needles
    for env in ("1", "0", None):
        with mock.patch.dict(os.environ):
            os.environ.pop("AMT_PREFILTER", None)
            if env is not None:
                os.environ["AMT_PREFILTER"] = env
            sp = Searcher(CASE_SENSITIVE, [(x.encode(), ()) for x in n2000], machine=m2000,
                          engine="cpp", device=dev)
            pf = sp._engine._prefilter()
            t1 = time.perf_counter()
            answers[env] = (sp.count_matches(h.data5), sp.contains_any(h.data5))
            pf_walls[env] = time.perf_counter() - t1
        engaged = env == "1" or (env is None and auto)
        check(isinstance(pf, PrefilterEngine) if engaged else pf is None,
              f"AMT_PREFILTER={env}: prefilter {'on' if pf else 'off'}")
    want_c = CppAcEngine(m2000).count(h.data5)
    check(answers["1"] == answers["0"] == answers[None] == (want_c, True),
          f"prefilter answers {answers}, host C++ {want_c}")
    print(f"stream prefilter: config 5's 2,000 needles over {len(h.data5)} bytes, cpp backend: "
          f"count {want_c}, contains_any True under AMT_PREFILTER=1 ({pf_walls['1']:.3f} s), "
          f"=0 ({pf_walls['0']:.3f} s) and unset ({pf_walls[None]:.3f} s, automatic rule "
          f"engaged: {auto}, {os.cpu_count()} cores); "
          f"{time.perf_counter() - t0:.1f} s host clock", flush=True)
    print(f"stream phase: {time.perf_counter() - t_phase:.1f} s wall ({card})", flush=True)
    return main, control


#: The tools phase: the ``count-matches`` files (bytes, seed), the configs'
#: corpus MiB (``--mb``), the scaling run's MiB per shard, and the chunks of
#: the streamed count whose idle share is read.
TOOLS_FILES = ((32 << 20, 3), ((4 << 20) + 12345, 4))
TOOLS_CONFIGS_MB = 32
TOOLS_SCALING_MB = 8
IDLE_STREAM_CHUNKS = 4
#: Runs ``cli.main`` on its arguments after the first in a fresh
#: interpreter, then writes the kernels' launch counts to the file named by
#: the first.
CLI_WRAP = """
import json, sys
from alfred_margaret_tpu_torch import cli, kernels as K
rc = cli.main(sys.argv[2:])
with open(sys.argv[1], "w") as f:
    json.dump({w.__name__: w.launches for w in K.WRAPPERS}, f)
raise SystemExit(rc)
"""


def tools_phase(h):
    """The port's tools on the card, each answer held against the host C++
    engine (or ``count_naive``, as the JAX modules hold theirs):
    ``dump-automaton`` on the bench needles against ``debug_build_dot``;
    ``count-matches`` through ``cli`` in a fresh interpreter on two bench
    files written by ``write_bench_file``, with ``AMT_ENGINE`` ``auto`` (B2),
    ``pallas`` (B1) and ``cpp`` (no kernel), its protocol and its launches
    read; ``driver.run_benchmark`` of ``python -m
    alfred_margaret_tpu_torch.cli count-matches`` over those files, 2 runs,
    and ``report.summarize`` of its ``.stats``; ``configs.main(["--mb",
    "32"])`` with each config's launches read at its JSON line (every config
    must launch a kernel; config 5 builds its 10,000 needles once);
    ``micro.main()``; ``scaling.main(["8"])`` on shards of the card (S2);
    the serving demo; and ``trace.profile`` with a trace dir around a staged
    ``count_matches``, ``contains_any`` and ``all_matches_arrays`` of the
    bench needles at ``CORPUS_BYTES`` and a count streamed in
    ``IDLE_STREAM_CHUNKS`` chunks, each trace read for the device's idle
    share: 1 - (union of kernel, copy and memset intervals) / the span.
    ``h`` carries ``main``'s helpers.  Returns the main-path launches."""
    import contextlib
    import glob
    import io
    import subprocess
    import tempfile

    import torch

    from alfred_margaret_tpu_torch import CASE_SENSITIVE, Searcher, cli
    from alfred_margaret_tpu_torch.bench import configs, driver, micro, report, scaling
    from alfred_margaret_tpu_torch.bench.dataformat import synth_corpus, write_bench_file
    from alfred_margaret_tpu_torch.bench.naive import count_naive
    from alfred_margaret_tpu_torch.examples import serving_demo
    from alfred_margaret_tpu_torch.models import ac
    from alfred_margaret_tpu_torch.native.cpp_engine import CppAcEngine
    from alfred_margaret_tpu_torch.utils import config, trace

    card, main, walls = h.card, {}, {}
    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    host = CppAcEngine(ac.build([(n, ()) for n in NEEDLES]))

    def run(label, fn, expect=()):
        """``fn()`` with the launch counts set to 0 just before and read just
        after; they join the phase's, and each of ``expect`` must be in
        them."""
        h.zero_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[label] = time.perf_counter() - t0
        used = {k: v for k, v in h.read_counts().items() if v}
        h.tally(main, used)
        for name in expect:
            check(used.get(name, 0) > 0, f"tools {label}: {name} was not launched ({used})")
        print(f"tools {label}: {walls[label]:.2f} s wall; launches {used} ({card})", flush=True)
        return out

    def captured(fn):
        """``fn()``'s return and its standard output, echoed."""
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = fn()
        print(buf.getvalue(), end="", flush=True)
        return rc, buf.getvalue()

    rc, dot = run("dump-automaton", lambda: captured(
        lambda: cli.main(["dump-automaton", *NEEDLES])))
    check(rc == 0 and dot == ac.debug_build_dot(NEEDLES), "dump-automaton != debug_build_dot")

    with tempfile.TemporaryDirectory() as tmp:
        data_dir = os.path.join(tmp, "data")
        os.makedirs(data_dir)
        files, want = [], 0
        for i, (size, seed) in enumerate(TOOLS_FILES):
            hay = synth_corpus(NEEDLES, size, hit_fraction=0.01, seed=seed)
            files.append(os.path.join(data_dir, f"bench{i}.txt"))
            write_bench_file(files[-1], NEEDLES, hay.decode())
            n = host.count(hay)
            check(n == count_naive([x.encode() for x in NEEDLES], hay), f"{files[-1]}: naive")
            want += n
        rounds = int(os.environ.get("AMT_ROUNDS", "5"))
        for engine, kernel in (("auto", "bitap_count"), ("pallas", "dense_count"), ("cpp", None)):
            counts_path = os.path.join(tmp, f"launches_{engine}.json")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-c", CLI_WRAP, counts_path, "count-matches", *files],
                cwd=root, env={**os.environ, "AMT_ENGINE": engine}, capture_output=True,
                text=True, timeout=600)
            wall = time.perf_counter() - t0
            check(proc.returncode == 0,
                  f"count-matches {engine}: exit {proc.returncode}: {proc.stderr[-3000:]}")
            lines = proc.stdout.split("\n")
            check(lines[-1] == "" and len(lines) == len(files) + 1
                  and all(x.endswith("\t") and len(x.split("\t")) == rounds + 1
                          for x in lines[:-1]), f"count-matches {engine}: stdout {proc.stdout!r}")
            got = int(proc.stderr.strip().splitlines()[-1])
            check(got == want, f"count-matches {engine}: {got} != host C++ {want}")
            with open(counts_path) as f:
                used = {k: v for k, v in json.load(f).items() if v}
            check(used.get(kernel, 0) > 0 if kernel else not used,
                  f"count-matches {engine}: launches {used}")
            h.tally(main, used)
            ms = [[int(t) / 1e6 for t in x.split("\t")[:-1]] for x in lines[:-1]]
            print(f"tools count-matches AMT_ENGINE={engine}: count {got} == host C++; rounds ms "
                  + "; ".join(f"file {i} ({os.path.getsize(p)} bytes) first {r[0]:.3f}, then "
                              f"{min(r[1:]):.3f}-{max(r[1:]):.3f}"
                              for i, (p, r) in enumerate(zip(files, ms)))
                  + f"; process wall {wall:.2f} s; launches {used} ({card})", flush=True)
            walls[f"count-matches {engine}"] = wall

        prefix = os.path.join(tmp, "port")
        t0 = time.perf_counter()
        with contextlib.chdir(root), mock.patch.dict(os.environ, {"AMT_ENGINE": "auto"}):
            driver.run_benchmark(f"{sys.executable} -m alfred_margaret_tpu_torch.cli "
                                 "count-matches", prefix, data_dir, runs=2)
        walls["driver"] = time.perf_counter() - t0
        with open(prefix + ".results") as f:
            results = f.read()
        check(results == f"{want}\n", f"driver: .results {results!r} != {want}")
        print(f"tools driver: 2 runs, {walls['driver']:.2f} s wall; "
              f"{report.summarize(prefix + '.stats')} ({card})", flush=True)

        # -- the BASELINE.json configs: each one's launches read at its line -----
        rows, per_config, emit = [], {}, configs._emit
        t_cfg = [time.perf_counter()]

        def spy(**kw):
            torch.cuda.synchronize()
            used = {k: v for k, v in h.read_counts().items() if v}
            h.zero_counts()
            h.tally(main, used)
            per_config[str(kw["config"])] = (used, time.perf_counter() - t_cfg[0])
            t_cfg[0] = time.perf_counter()
            rows.append(kw)
            return emit(**kw)

        h.zero_counts()
        t0 = time.perf_counter()
        with mock.patch.object(configs, "_emit", spy):
            check(configs.main(["--mb", str(TOOLS_CONFIGS_MB)]) == 0, "configs.main")
        walls["configs"] = time.perf_counter() - t0
        check([str(r["config"]) for r in rows] == ["1", "2", "2b", "3", "4", "5"],
              f"configs emitted {[r['config'] for r in rows]}")
        for name, (used, wall) in per_config.items():
            check(sum(used.values()) > 0, f"config {name} launched no kernel")
            print(f"tools config {name}: {wall:.2f} s wall; launches {used} ({card})", flush=True)
        c5 = rows[-1]
        print(f"tools config 5: {c5['needles']} needles, Searcher build {c5['build_seconds']} s, "
              f"first count (the device engine's build) {c5['first_count_seconds']} s, count "
              f"{c5['seconds']} s over {c5['bytes']} bytes ({card})", flush=True)

        # -- micro, scaling, the serving demo -------------------------------------
        rc, out = run("micro", lambda: captured(lambda: micro.main([])), ("bitap_count",))
        by = {(r["scenario"], r["impl"]): r["result"] for r in map(json.loads, out.splitlines())}
        check(rc == 0 and len(by) == 44, f"micro: {len(by)} rows")
        for name, needle, hay in micro.scenarios():
            n = CppAcEngine(ac.build([(needle, ())])).count(hay.encode())
            check(by[(name, "ac")] == n == by[(name, "nfa")] == by[(name, "bm")],
                  f"micro {name}: ac {by[(name, 'ac')]} != host C++ {n}")
            check(by[(name, "ac-ci")] == by[(name, "bm-ci")] == by[(name, "bm-ci-classic")],
                  f"micro {name}: ac-ci != bm-ci")
        rc, out = run("scaling", lambda: captured(
            lambda: scaling.main([str(TOOLS_SCALING_MB)])), ("bitap_count",))
        srows = [json.loads(x) for x in out.splitlines()]
        inv = host.count(synth_corpus(NEEDLES, 4 << 20, hit_fraction=0.01, seed=7))
        check(rc == 0 and srows[0] == {"invariance": "ok", "shapes": 10, "count": inv},
              f"scaling invariance {srows[0]} (host C++ {inv})")
        for row in srows[1:]:
            n = row["devices"]
            want_n = host.count(synth_corpus(NEEDLES, TOOLS_SCALING_MB * n << 20,
                                             hit_fraction=0.01, seed=3))
            check(row["count"] == want_n and row.get("virtual_mesh", False) == (n > 1),
                  f"scaling row {row}: host C++ {want_n}")
        rc, out = run("serving demo", lambda: captured(lambda: serving_demo.main("cuda")),
                      ("bitap_count",))
        check(out.rstrip().endswith("ALL STEPS EXACT"), "serving demo")

        # -- the device's idle share, from torch.profiler traces -------------------
        check(config.DEFAULT.stream_chunk_mb << 20 == CORPUS_BYTES,
              "AMT_STREAM_CHUNK_MB is set: the streamed case measures the default chunk")
        s = Searcher.build(CASE_SENSITIVE, NEEDLES)
        data = np.frombuffer(synth_corpus(NEEDLES, CORPUS_BYTES, hit_fraction=0.01, seed=3),
                             np.uint8)
        staged = s.stage(data)
        big = np.tile(data, IDLE_STREAM_CHUNKS)
        hm = host.matches_arrays(data)
        idle = {}
        with trace.profile(0, label="warm", trace_dir=os.path.join(tmp, "warm")):
            torch.ones(1, device=h.dev).sum()  # CUPTI's set-up stays out of the cases
        for label, fn, want_v, n_bytes in (
                ("count_matches", lambda: s.count_matches(staged), host.count(data), len(data)),
                ("contains_any", lambda: s.contains_any(staged), host.first_hit(data) >= 0,
                 len(data)),
                ("all_matches_arrays", lambda: s.all_matches_arrays(staged), hm, len(data)),
                ("streamed_count_matches", lambda: s.count_matches(big), host.count(big),
                 len(big))):
            fn()  # warm: lazy tables, the first scan's set-up
            plain = []  # the host-clock wall without the profiler
            for _ in range(5):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                plain.append(time.perf_counter() - t0)
            plain_ms = sorted(plain)[2] * 1e3
            tdir = os.path.join(tmp, "trace_" + label)

            def traced():
                with trace.profile(n_bytes, label=label, trace_dir=tdir) as st:
                    out = fn()
                return out, st

            out, st = run(f"idle {label}", traced)
            ok = (all(np.array_equal(a, b) for a, b in zip(out, want_v))
                  if isinstance(out, tuple) else out == want_v)
            check(ok, f"idle {label}: answer != host C++")
            (path,) = glob.glob(os.path.join(tdir, "*.json"))
            share = trace.device_idle_share(path, label)
            check(share["kernel"] > 0, f"the trace of {label} recorded no kernel: {share}")
            # ``idle_share`` takes the busy time and the wall from the same
            # (profiled) run.  The profiler lengthens the host's side of the
            # wall, so the busy time over the median wall of the unprofiled
            # runs is printed beside it, unclipped: these are other runs, and
            # where the busy time exceeds their wall (a negative share) the
            # two disagree, which the line says.
            share["plain_wall_ms"] = plain_ms
            share["idle_share_of_plain_wall"] = 1 - share["busy_us"] / 1e3 / plain_ms
            share["busy_exceeds_plain_wall"] = share["idle_share_of_plain_wall"] < 0
            idle[label] = share
            print(f"tools idle {label}: {n_bytes} bytes, wall {st.seconds * 1e3:.3f} ms "
                  f"(trace span {share['wall_us'] / 1e3:.3f} ms), device busy "
                  f"{share['busy_us'] / 1e3:.3f} ms, idle share {share['idle_share']:.4f}; "
                  f"without the profiler (other runs): median wall {plain_ms:.3f} ms, idle share "
                  f"against it {share['idle_share_of_plain_wall']:.4f}"
                  + (" (the busy time of the profiled run exceeds this wall: the runs "
                     "disagree)" if share["busy_exceeds_plain_wall"] else "")
                  + f"; {share['kernel']} kernels, "
                  f"{share['gpu_memcpy']} copies, {share['gpu_memset']} memsets in the trace; "
                  "most device time: " + "; ".join(f"{name[:60]} {us / 1e3:.3f} ms"
                                                    for name, us in share["top"])
                  + f" ({card})", flush=True)
    print("tools idle shares " + json.dumps({"card": card, **idle}), flush=True)
    print(f"tools phase: {time.perf_counter() - t_phase:.1f} s wall ({card}); "
          + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items()), flush=True)
    return main


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; needs one CUDA card",
              file=sys.stderr)
        return 1

    from alfred_margaret_tpu_torch import (
        CASE_SENSITIVE, IGNORE_CASE, MatchEngine, Searcher, toolchain_report)
    from alfred_margaret_tpu_torch import kernels as K
    from alfred_margaret_tpu_torch.bench.configs import config2_needles, config5_needles
    from alfred_margaret_tpu_torch.bench.dataformat import synth_corpus
    from alfred_margaret_tpu_torch.kernels import build
    from alfred_margaret_tpu_torch.kernels.bitap_contains import (bitap_contains_design,
                                                                  bitap_presence_design)
    from alfred_margaret_tpu_torch.kernels.bitap_count import bitap_count_design
    from alfred_margaret_tpu_torch.kernels.comb import comb_count_design
    from alfred_margaret_tpu_torch.kernels.comb16 import comb16_count_design
    from alfred_margaret_tpu_torch.kernels.comb16_grouped import comb16_grouped_design
    from alfred_margaret_tpu_torch.kernels.dense_contains import dense_contains_design
    from alfred_margaret_tpu_torch.kernels.dense_count import dense_count_design, dense_states_design
    from alfred_margaret_tpu_torch.kernels.filter_contains import filter_contains_design
    from alfred_margaret_tpu_torch.kernels.matchbits import matchbits_design
    from alfred_margaret_tpu_torch.kernels.screen_count import screen_count_design
    from alfred_margaret_tpu_torch.kernels.segments import (
        Design, chunk_smem_bytes, comb_smem_bytes, dense_bits_smem_bytes, filter_smem_bytes)
    from alfred_margaret_tpu_torch.models import ac, case_dfa
    from alfred_margaret_tpu_torch.native import build as native_build
    from alfred_margaret_tpu_torch.native.cpp_engine import CppAcEngine
    from alfred_margaret_tpu_torch.ops.bitap_scan import BitapAcEngine, plan_bitap, plan_bitap_ci
    from alfred_margaret_tpu_torch.ops.comb16_scan import Comb16AcEngine
    from alfred_margaret_tpu_torch.ops.comb_scan import CombAcEngine, make_engine
    from alfred_margaret_tpu_torch.ops.filter_scan import FilterTables, plan_filter
    from alfred_margaret_tpu_torch.ops.grouped import GroupedAcEngine
    from alfred_margaret_tpu_torch.ops.pallas_scan import DenseAcEngine, _zero_inert
    from alfred_margaret_tpu_torch.ops.xla_scan import XlaAcEngine
    from alfred_margaret_tpu_torch.utils import utf8
    from alfred_margaret_tpu_torch.utils.device import nvidia_smi_line

    def dense_control(s):
        """A searcher over ``s``'s machine whose device engine is the dense
        engine: the control of a bitap-eligible set."""
        d = Searcher(CASE_SENSITIVE, s.needles, machine=s.automaton, device="cuda")
        d._engine._device_eng = DenseAcEngine(s.automaton, device=d.device)
        return d

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
            args = eng.contains_args(st)
            same("bitap_contains", K.bitap_contains(*args), K.bitap_contains_plain(*args), label)
            args = eng.presence_args(st)
            same("bitap_presence", K.bitap_presence(*args), K.bitap_presence_plain(*args), label)
        elif isinstance(eng, Comb16AcEngine):
            args = eng.sticky_args(st)
            same("comb16_contains", K.comb16_contains(*args), K.comb16_contains_plain(*args), label)
            if eng._filter_tables is not None:
                args = (st.streams, st.vend, *eng._filter_tables.args(), st.plan.overlap)
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
        counts, bits = K.matchbits(*args, overlap=st.plan.overlap)
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

    v2, pk2 = TWO_WORD_NEEDLES, PACK2_NEEDLES
    c2 = config2_needles()
    n97 = [n for n in c2 if len(n) >= 4]
    cases = [
        ("bitap_count", "bench needles", NEEDLES),
        ("bitap_count", "overlap and suffix needles", ["ab", "b", "abc", "zz"]),
        ("bitap_count", "duplicate needles", ["x", "x", "yy", "x"]),
        ("bitap_count", "two words (V=2)", v2),
        ("dense_count", "bench needles, dense engine", NEEDLES),
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
        if eng._screen is not None:  # the count's suffix screen, with its pass counter
            sc = eng._screen
            sc.passes.zero_()
            got = K.screen_count(st.streams, st.warm, st.vend, sc, st.plan.overlap)
            torch.cuda.synchronize()
            k_passes = int(sc.passes)
            sc.passes.zero_()
            same("screen_count", got, K.screen_count_plain(st.streams, st.warm, st.vend, sc), label)
            check(k_passes == int(sc.passes) > 0,
                  f"{label}: screen passes {k_passes} != plain {int(sc.passes)}")
            same("screen_count", got, eng.stream_counts(st), f"{label}, against B9")
        args = eng.sticky_args(st)
        same("comb16_contains_grouped", K.comb16_contains_grouped(*args),
             K.comb16_contains_grouped_plain(*args), label)
        if eng._filter_tables is not None:
            args = (st.streams, st.vend, *eng._filter_tables.args(), st.plan.overlap)
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
    check(eng5._screen is not None, "1,000 needles: no suffix screen for the count")
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
    dense_searcher = dense_control(searcher)
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
    miss_dense, absent_dense = dense_control(miss), dense_control(absent)
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
    nofilter = Searcher(CASE_SENSITIVE, s100.needles, machine=s100.automaton)
    nofilter._engine.device_engine()._filter_tables = None  # the control: no screen
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
    ops2 += [(f"contains_any {k}", "unscreened", (lambda v=v: nofilter.contains_any(v)))
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
    print(f"comb16 path: every answer == host C++ == unscreened control; "
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

    # The controls: the same machine's grouped engine with no screen, with
    # no screen and no fused table set (the groups' own passes), and with no
    # suffix screen for the count (B9).
    per_group = Searcher(CASE_SENSITIVE, s1000.needles, machine=s1000.automaton)
    unscreened = Searcher(CASE_SENSITIVE, s1000.needles, machine=s1000.automaton)
    b9_control = Searcher(CASE_SENSITIVE, s1000.needles, machine=s1000.automaton)
    for s in (per_group, unscreened):
        s._engine.device_engine()._filter_tables = None
    pg = per_group._engine.device_engine()
    pg._fused_tried = pg._fused_sticky_tried = True
    pg._screen = b9_control._engine.device_engine()._screen = None
    ops5 = [("count_matches", "main path", lambda: s1000.count_matches(st5["config 5"]))]
    ops5 += [(f"contains_any {k}", "main path", (lambda v=v: s1000.contains_any(v)))
             for k, v in st5.items()]
    ops5 += [
        ("contains_all true", "main path", lambda: s1000.contains_all(staged5_all)),
        ("contains_all false", "main path", lambda: s1000.contains_all(st5["config 5"])),
        ("all_matches_arrays", "main path", lambda: s1000.all_matches_arrays(st5["config 5"])),
        ("count_matches", "per group", lambda: per_group.count_matches(st5["config 5"])),
        ("count_matches", "B9", lambda: b9_control.count_matches(st5["config 5"])),
    ]
    ops5 += [(f"contains_any {k}", "per group", (lambda v=v: per_group.contains_any(v)))
             for k, v in st5.items()]
    ops5 += [(f"contains_any {k}", "unscreened", (lambda v=v: unscreened.contains_any(v)))
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
        "count_matches": {"screen_count"},
        "contains_any config 5": {"filter_contains", "comb16_contains_grouped"},  # candidates
        "contains_any fire-free": {"filter_contains"},  # no fire: the screen says False
        "contains_any digits (2b)": {"filter_contains", "comb16_contains_grouped"},
        "contains_any digits + 1 needle": {"filter_contains", "comb16_contains_grouped"},
        "contains_all true": extract5,
        "contains_all false": extract5,
        "all_matches_arrays": extract5,
    }
    control_kernels = {
        "per group": {"comb_count", "comb16_count", "comb_contains", "comb16_contains"},
        "unscreened": {"comb16_contains_grouped"},
        "B9": {"comb16_count_grouped"},
    }
    g_main, g_control = {}, {}
    for op, who, used in run_ops(ops5, want5):
        if who == "main path":
            check(set(used) == expect5[op], f"{op}: launched {used}, expected {expect5[op]}")
            if op == "count_matches":
                check(used == {"screen_count": 1}, f"count launched {used}")
            if set(used) == extract5:
                check(used["comb_count"] == n_c32 and used["matchbits_comb16"] == n_c16
                      and 0 < used["comb_states"] <= n_c32, f"{op}: a group was skipped: {used}")
            tally(g_main, used)
        else:
            check(used and set(used) <= control_kernels[who], f"{op} ({who}): launched {used}")
            tally(g_control, used)
    for name in ("screen_count", "comb16_contains_grouped", "filter_contains",
                 "comb_count", "comb_states", "matchbits_comb16"):
        check(g_main.get(name, 0) > 0, f"{name} was not launched by the grouped path")
    check(g_control.get("comb16_count_grouped", 0) == 1, "B9's count control did not run")
    print(f"grouped path: stage 5 x {CORPUS_BYTES} bytes {stage5_s:.3f} s; every answer == "
          f"host C++ == per-group control == unscreened control == B9 control; launches "
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
    ci1_dense = MatchEngine(ci1.machine, device=dev)  # the control: B1 on composed tables
    ci1_dense._device_eng = DenseAcEngine(ci1.machine, device=dev)
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
        ("count_matches", "dense control", ctrl("count")),
        ("contains_any", "main path", lambda: s_ci.contains_any(staged_ci)),
        ("contains_any", "dense control", ctrl("contains_any")),
        ("contains_any miss", "main path", lambda: miss_ci.contains_any(staged_miss_ci)),
        ("contains_all", "main path", lambda: s_ci.contains_all(staged_ci)),
        ("contains_all", "dense control", lambda: bool(ci1_dense.value_presence(
            staged_ci, CASE_SENSITIVE).all())),
        ("contains_all false", "main path", lambda: absent_ci.contains_all(staged_absent_ci)),
        ("all_matches_arrays", "main path", lambda: s_ci.all_matches_arrays(staged_ci)),
        ("all_matches_arrays", "dense control",
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
    trap_hays = {}  # label: (corpus, its staging), for the mesh phase
    for label, n_hit, route in (("few", min(100, S_ci // 200), "host recount"),
                                ("many", min(1000, S_ci), "dense fallback")):
        hay = with_traps(n_hit, 40 + n_hit)
        want_t = host_answers(host_ci, hay, len(NEEDLES))
        sst = s_ci.stage(hay)
        trap_hays[label] = (hay, sst)
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
        check(used and set(used) <= {"screen_count", "comb_count", "comb_states",
                                     "matchbits_comb16", "comb16_count", "comb16_states"},
              f"lowering path {op}: launched {used}")
        tally(ci_main, used)
    oracle_check(s600, data600[:ORACLE_BYTES].tobytes() + PROBES, "config 5's 600, 64 KiB")

    # Phase 5: B2, B4 and B7 with trap tables against their plain versions.
    reg_needles = TRAP_REGISTER_NEEDLES
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
        kargs, sargs = e._kernel_args(sst), e.presence_args(sst)
        for name, kernel, plain, args in (
                ("bitap_count", K.bitap_count, K.bitap_count_plain, kargs),
                ("bitap_contains", K.bitap_contains, K.bitap_contains_plain, e.contains_args(sst)),
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

    # -- the Replacer, the Splitter and adopt_staged at 128 MiB ------------------
    api_main = api_phase(SimpleNamespace(
        dev=dev, card=card, zero_counts=zero_counts, read_counts=read_counts, tally=tally,
        corpus_bytes=CORPUS_BYTES, data=data, staged=staged, stage_s=stage_s, absent=absent,
        s30=s30, s100=s100, s300=s300, s1000=s1000, s_ci=s_ci, data_ci=data_ci, c2=c2,
        data2=data2, n600=n600, n30=n30, n1000=n1000))

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
        _, bits = K.matchbits(*bits_eng.bits_args(sst), overlap=sst.plan.overlap)
        w = bits.long() & 0xFFFFFFFF  # [T/32, S]
        nz = w != 0
        word = torch.argmax(nz.int(), dim=0)  # first non-zero word (0 when none)
        low = w.gather(0, word.unsqueeze(0)).squeeze(0)
        bit = torch.log2((low & -low).double().clamp(min=1)).long()
        t = word * 32 + bit
        return torch.where(nz.any(0) & (t < vend), t + 1, vend).clamp(max=sst.plan.time_len)

    def saturation_steps(bits_eng, sst):
        """int64 [S]: the steps each stream of ``sst`` must read before B4's
        output for ``bits_eng``'s bitap layout is final: up to the step at
        which the OR of ``D & endmask`` over words and steps holds every end
        bit of the layout, else its ``vend``.  A plain shift-AND scan."""
        t = bits_eng.bitap_tables
        bt, sd = t.btab.long(), t.seed.long().unsqueeze(1)
        em = t.endmask.long()
        full = 0
        for w in em.tolist():
            full |= w
        D = torch.zeros(bt.shape[0], sst.plan.n_streams, dtype=torch.int64, device=dev)
        acc = torch.zeros(sst.plan.n_streams, dtype=torch.int64, device=dev)
        steps = sst.vend.clamp(max=sst.plan.time_len).long()
        for i in range(sst.plan.time_len):
            D = ((D << 1) | sd) & bt[:, sst.streams[i].long()]
            for w in range(bt.shape[0]):
                acc |= D[w] & em[w]
            steps = torch.where(acc == full, steps.clamp(max=i + 1), steps)
        return steps

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
            if hasattr(a, "recs"):  # the suffix screen's
                tabs += [a.bitmap, a.slots, a.recs]
        return sum(a.numel() * a.element_size() for a in tabs)

    def n_live_bytes(sst):
        return int(sst.vend.clamp(max=sst.plan.time_len).long().sum())

    miss_eng = miss_dense._engine.device_engine()
    st_c2, st_digits = st2["config 2"].device, st2["digits (2b)"].device
    S = st.plan.n_streams
    T = st.plan.time_len
    need_bench = int(first_hit_steps(bitap_eng, st).sum())
    # B4's output is final once it holds every end bit of the layout.
    sat = saturation_steps(bitap_eng, st)
    live = st.vend.clamp(max=st.plan.time_len).long()
    need_b4 = int(sat.sum())
    early = sat < live
    n_blocks = (S + 127) // 128
    blocks = torch.zeros(n_blocks * 128, dtype=torch.bool, device=dev)
    blocks[:S] = early | (live == 0)
    print(f"B4 bench needles: {int(early.sum())} of {S} streams hold every end bit before their "
          f"vend; {int(blocks.view(n_blocks, 128).all(1).sum())} of {n_blocks} blocks of 128 all "
          f"of them; steps needed {need_b4} of {n_live_bytes(st)} live", flush=True)
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
    first3 = first_hit_steps(eng3, st3c)
    need3 = int(first3.sum())
    need3d = int(first_hit_steps(eng3, st3d).sum())
    # B16's threads step in warps of 32 streams: a warp runs until its last
    # stream's first match, so on config 5's corpus it must take far more
    # steps than its streams need alone.
    warp3 = torch.nn.functional.pad(first3, (0, (-first3.numel()) % 32)).view(-1, 32).max(1).values
    live3 = n_live_bytes(st3c)
    warp_share3 = 32 * int(warp3.sum()) / live3
    print(f"B16 config 5 corpus: a stream's first match at a median of "
          f"{int(first3.median())} steps ({need3 / live3:.3f} of the live bytes), a warp's last at "
          f"a median of {int(warp3.median())} ({warp_share3:.3f} of the live bytes)", flush=True)
    T3 = st3c.plan.time_len
    def bits_kernel(sst):
        """B6 (B13) as the extraction launches it on ``sst``: with its plan's
        overlap."""
        return lambda *a: K.matchbits(*a, overlap=sst.plan.overlap)

    # B14 as the screen launches it (the layout's restart, the plan's
    # overlap), and the bytes it needs: each stream until its planes are
    # final (an exact hit, or no short needle, and every end bit in cand),
    # else to its vend rounded up to a whole pair.
    def screen_steps(sst, tabs):
        T_s = sst.plan.time_len
        bt = tabs.btab.long() & 0xFFFFFFFF
        sd = (tabs.seed.long() & 0xFFFFFFFF).unsqueeze(1)
        em = (tabs.endmask.long() & 0xFFFFFFFF).unsqueeze(1)
        sm = (tabs.short_mask.long() & 0xFFFFFFFF).unsqueeze(1)
        sc = (tabs.short_const.long() & 0xFFFFFFFF).unsqueeze(1)
        full = 0
        for w in tabs.endmask.tolist():
            full |= w & 0xFFFFFFFF
        n = sst.plan.n_streams
        D = torch.zeros(bt.shape[0], n, dtype=torch.int64, device=dev)
        roll = torch.zeros(n, dtype=torch.int64, device=dev)
        exact = torch.full((n,), int(sm.numel() == 0), dtype=torch.int64, device=dev)
        cand = torch.zeros(n, dtype=torch.int64, device=dev)
        steps = ((sst.vend.clamp(max=T_s).long() + 1) // 2) * 2
        rows_v = torch.arange(bt.shape[0], device=dev).unsqueeze(1)
        for u in range(T_s // 2):
            b1, b2 = sst.streams[2 * u].long(), sst.streams[2 * u + 1].long()
            h = ((b1 & 15) << 3) | (b2 & 7)
            D = (((D << 1) | sd) & bt[rows_v, h.unsqueeze(0)]) & 0xFFFFFFFF
            for w in range(bt.shape[0]):
                cand |= D[w] & em[w]
            roll = ((roll << 16) | (b1 << 8) | b2) & 0xFFFFFFFF
            if sm.numel():
                exact |= (((roll & sm) == sc) | (((roll >> 8) & sm) == sc)).any(0).long()
            steps = torch.where((exact > 0) & (cand == full), steps.clamp(max=2 * u + 2), steps)
        return int(steps.sum())

    b14_args = (st_c2.streams, st_c2.vend, *eng2._filter_tables.args(), st_c2.plan.overlap)
    b14_args5 = (st5c.streams, st5c.vend, *eng5._filter_tables.args(), st5c.plan.overlap)
    need14, need14_5 = screen_steps(st_c2, eng2._filter_tables), screen_steps(st5c, eng5._filter_tables)
    print(f"B14 bytes needed: config 2 {need14} of {n_live_bytes(st_c2)} live, config 5 "
          f"{need14_5} of {n_live_bytes(st5c)}", flush=True)

    # B3 as the dense path's contains_any launches it: four quarter ranges of
    # the 30 needles' streams, in corpus order (contains_staged_early's K = 4).
    st30q = staged30.device
    need30 = int(first_hit_steps(dense30, st30q).sum())

    T30 = st30q.plan.time_len
    what30 = f"30 needles, packing {dense30.comp.packing}"

    def quarters(*args):
        return torch.cat([K.dense_contains(*dense30.sticky_args(st30q, q * S // 4, (q + 1) * S // 4))
                          for q in range(4)])

    # (name, kernel, plain, args, what, stream bytes the function needs,
    #  output bytes, operations: one 32-bit state update per byte and word)
    timings, designs = {}, {}
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
        ("dense_contains", quarters, K.dense_contains_plain, dense30.sticky_args(st30q),
         "30 needles, four quarter launches", need30, 4 * S, need30),
        ("bitap_contains", K.bitap_contains, K.bitap_contains_plain,
         bitap_eng.contains_args(st), "bench needles", need_b4, 4 * S,
         need_b4 * bitap_eng.bitap.n_words),
        ("bitap_presence", K.bitap_presence, K.bitap_presence_plain,
         bitap_eng.presence_args(st), "bench needles", n_live_bytes(st),
         4 * S * bitap_eng.bitap.n_words, n_live_bytes(st) * bitap_eng.bitap.n_words),
        ("matchbits", bits_kernel(st), K.matchbits_plain, bitap_eng.bits_args(st),
         "bench needles, bitap step", T * S, 4 * S + T // 32 * S * 4, T * S),
        ("matchbits", bits_kernel(st), K.matchbits_plain, dense_eng.bits_args(st),
         "bench needles, dense step", T * S, 4 * S + T // 32 * S * 4, T * S),
        ("comb16_count", K.comb16_count, K.comb16_count_plain, eng2._kernel_args(st_c2),
         "config 2", n_live_bytes(st_c2), 4 * S, n_live_bytes(st_c2)),
        ("comb16_contains", K.comb16_contains, K.comb16_contains_plain,
         eng2.sticky_args(st_digits), "config 2, digits corpus: full scan", need_digits, 4 * S,
         need_digits),
        ("comb16_contains", K.comb16_contains, K.comb16_contains_plain,
         eng2.sticky_args(st_c2), "config 2 corpus: stops at the first match", need_c2, 4 * S,
         need_c2),
        ("matchbits_comb16", bits_kernel(st_c2), K.matchbits_plain, eng2.bits_args(st_c2),
         "config 2, comb16 step", T2 * S, 4 * S + T2 // 32 * S * 4, T2 * S),
        ("filter_contains", K.filter_contains, K.filter_contains_plain, b14_args, "config 2",
         need14, 8 * S, need14 // 2 * (lay.n_words + 2 * len(lay.shorts))),
        ("filter_contains", K.filter_contains, K.filter_contains_plain, b14_args5,
         "config 5, 12 words", need14_5, 8 * S,
         need14_5 // 2 * (lay5.n_words + 2 * len(lay5.shorts))),
        ("comb16_count_grouped", K.comb16_count_grouped, K.comb16_count_grouped_plain,
         (st5c.streams, st5c.warm, st5c.vend, f5, st5c.plan.overlap), "config 5",
         n_live_bytes(st5c), 4 * S,
         n_live_bytes(st5c) * G5),
        ("screen_count", K.screen_count, K.screen_count_plain,
         (st5c.streams, st5c.warm, st5c.vend, eng5._screen, st5c.plan.overlap), "config 5",
         n_live_bytes(st5c), 4 * S, n_live_bytes(st5c)),
        ("comb16_contains_grouped", K.comb16_contains_grouped, K.comb16_contains_grouped_plain,
         eng5.sticky_args(st5d), "config 5, digits corpus: full scan", need5d, 4 * S,
         need5d * Y5),
        ("comb16_contains_grouped", K.comb16_contains_grouped, K.comb16_contains_grouped_plain,
         eng5.sticky_args(st5c), "config 5 corpus: stops at the first match", need5,
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
        ("dense_states", K.dense_states, K.dense_states_plain, dense30.states_args(st30q),
         what30, T30 * S, 4 * T30 * S, T30 * S),
        ("comb16_states", K.comb16_states, K.comb16_states_plain, eng2.states_args(st_c2),
         "config 2", T2 * S, 4 * T2 * S, T2 * S),
        ("bitap_count_trap", K.bitap_count, K.bitap_count_plain, eng_ci._kernel_args(st_ci),
         "IgnoreCase bench needles, embedded trap", n_live_bytes(st_ci), 8 * S,
         n_live_bytes(st_ci) * VT_ci),
        ("bitap_count_trap", K.bitap_count, K.bitap_count_plain, eng_reg._kernel_args(st_ci),
         "IgnoreCase 5 needles, trap register", n_live_bytes(st_ci), 8 * S,
         n_live_bytes(st_ci) * VT_reg),
        ("bitap_contains_trap", K.bitap_contains, K.bitap_contains_plain,
         eng_ci.contains_args(st_ci), "IgnoreCase bench needles, embedded trap",
         n_live_bytes(st_ci), 8 * S, n_live_bytes(st_ci) * VT_ci),
        ("bitap_presence_trap", K.bitap_presence, K.bitap_presence_plain,
         eng_ci.presence_args(st_ci), "IgnoreCase bench needles, embedded trap",
         n_live_bytes(st_ci), 4 * S * VT_ci, n_live_bytes(st_ci) * VT_ci),
        ("bitap_presence_trap", K.bitap_presence, K.bitap_presence_plain,
         eng_reg.presence_args(st_ci), "IgnoreCase 5 needles, trap register",
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
        if name.startswith("bitap_count"):  # B2's segments with the plan's overlap
            designs[(name, what)] = bitap_count_design(args[0], args[1], args[5],
                                                       args[9]).as_dict()
        elif name.startswith("bitap_contains"):  # B4's
            designs[(name, what)] = bitap_contains_design(args[0], args[1], args[5]).as_dict()
        elif name.startswith("bitap_presence"):  # B7's
            designs[(name, what)] = bitap_presence_design(args[0], args[1], args[5]).as_dict()
        elif name == "comb16_count":  # B8's
            designs[(name, what)] = comb16_count_design(args[0], args[4], args[5],
                                                        args[13]).as_dict()
        elif name == "dense_count":
            designs[(name, what)] = dense_count_design(args[0], args[2], args[7]).as_dict()
        elif name == "dense_contains":  # B3's, on its range (a quarter's for the quarters)
            s1 = args[8] // 4 if what.endswith("quarter launches") else args[8]
            designs[(name, what)] = design_of(
                dense_contains_design(args[0], args[2], args[9], args[7], s1),
                dense_bits_smem_bytes(args[2].numel()))
        elif name == "comb16_states":  # B12's, with the full tables' shared memory
            designs[(name, what)] = design_of(
                comb16_count_design(args[0], args[2], args[3], args[10]),
                chunk_smem_bytes(1, args[2].numel(), args[3].numel()))
        elif name == "comb16_contains":  # B10's, on the sticky tables
            designs[(name, what)] = design_of(
                comb16_count_design(args[0], args[3], args[4], args[11]),
                chunk_smem_bytes(1, args[3].numel(), args[4].numel()))
        elif name == "dense_states":  # B5's, with B1's shared memory
            designs[(name, what)] = design_of(dense_states_design(args[0], args[2], args[5]),
                                              dense_bits_smem_bytes(args[2].numel()))
        elif name == "comb_contains":  # B16's, with B15's shared memory
            designs[(name, what)] = design_of(comb_count_design(args[0], args[3], args[4], args[10]),
                                              comb_smem_bytes(args[3].numel(), args[4].numel()))
        elif name == "filter_contains":  # B14's segments, restart and table layout
            designs[(name, what)] = {
                **design_of(filter_contains_design(args[0], args[2], args[7], args[8]),
                            filter_smem_bytes(args[2].shape[0])),
                "restart": args[7], "layout": "[V][128]"}
        if (name, what) in designs:
            print(f"design {name:16s} {what:44s} {designs[(name, what)]}")

    # B9 (eleven groups, and one alone as on a mesh shard) and B15 at the edge
    # shapes of their redesign: S not a multiple of 128 (byte-wise staging
    # where S % 16 != 0), T below a tile, ragged warm-ups and vends.
    edge_src = np.frombuffer(synth_corpus(config5_needles(1000)[:300], 1 << 20,
                                          hit_fraction=0.05, seed=5), np.uint8)

    def edge_streams(T_e, S_e, K_e, seed, src=edge_src):
        rng = np.random.default_rng(seed)
        off = rng.integers(0, len(src) - T_e, S_e)
        win = np.ascontiguousarray(src[off[None, :] + np.arange(T_e)[:, None]])
        vend_e = rng.integers(0, T_e + 1, S_e)
        vend_e[rng.random(S_e) < 0.1] = 0

        def put(x, dtype):
            return torch.from_numpy(np.ascontiguousarray(x)).to(dev, dtype)

        return (put(win, torch.uint8), put(rng.integers(0, K_e + 1, S_e), torch.int32),
                put(vend_e, torch.int32))

    over5, over3 = st5c.plan.overlap, st3c.plan.overlap
    n_edge = 0
    for T_e, S_e in ((20, 1000), (300, 200), (300, 1040), (1000, 4096)):
        for label, tabs in (("G = 11", f5), ("G = 1", f5.group(0))):
            s_e, w_e, v_e = edge_streams(T_e, S_e, over5, T_e + S_e)
            same("comb16_count_grouped", K.comb16_count_grouped(s_e, w_e, v_e, tabs, over5),
                 K.comb16_count_grouped_plain(s_e, w_e, v_e, tabs),
                 f"{label}, edge shape T={T_e} S={S_e}")
            n_edge += 1
        s_e, w_e, v_e = edge_streams(T_e, S_e, over3, T_e * S_e)
        targs = eng3.tables.args()
        same("comb_count", K.comb_count(s_e, w_e, v_e, *targs, over3),
             K.comb_count_plain(s_e, w_e, v_e, *targs), f"edge shape T={T_e} S={S_e}")
        n_edge += 1
    print(f"edge shapes: B9 (G = 11, G = 1) and B15 == plain on {n_edge} launches "
          "(S 200 / 1000 / 1040 / 4096, T 20 / 300 / 1000, ragged vend)", flush=True)

    # B11 (config 5's sticky groups, and one alone as on a mesh shard) and
    # B17 at the same edge shapes and one stream alone, with the plan's
    # overlap, with none, and on single bytes (overlap 0); every stream
    # padded (vend 0, zero bytes) too.
    singles = ac.build([(x, i) for i, x in enumerate(["a", "e", " ", "z"])])
    y1 = sticky_groups(Comb16AcEngine(singles, device=dev).sticky_tables(), 3)
    s1_tabs = CombAcEngine(singles, device=dev).full_tables.args()
    f3 = eng3.full_tables.args()
    n_edge = 0
    for T_e, S_e in ((20, 1000), (300, 200), (300, 1040), (1000, 4096), (300, 1)):
        s_e, _, v_e = edge_streams(T_e, S_e, over5, T_e + S_e + 2)
        pad = torch.zeros_like(v_e)
        for label, tabs, over in ((f"G = {Y5}", y5, over5), ("G = 1", y5.group(0), over5),
                                  ("G = 1, no overlap", y5.group(Y5 - 1), None),
                                  ("singles, overlap 0", y1, 0),
                                  ("singles G = 1, overlap 0", y1.group(0), 0)):
            fn, plain = ((K.comb16_contains_grouped, K.comb16_contains_grouped_plain)
                         if tabs.n_groups > 1 else
                         (K.comb16_contains_base, K.comb16_contains_base_plain))
            for v, pl in ((v_e, ""), (pad, ", every stream padded")):
                same(fn.__name__, fn(s_e, v, tabs, over), plain(s_e, v, tabs),
                     f"{label}, edge shape T={T_e} S={S_e}{pl}")
                n_edge += 1
        s_e, _, _ = edge_streams(T_e, S_e, over3, T_e * S_e + 3)
        for label, tabs, over, st_e in (("300 needles", f3, over3, s_e),
                                        ("300 needles, no overlap", f3, None, s_e),
                                        ("300 needles, zero bytes", f3, over3,
                                         torch.zeros_like(s_e)),
                                        ("singles, overlap 0", s1_tabs, 0, s_e)):
            same("comb_states", K.comb_states(st_e, *tabs, over), K.comb_states_plain(st_e, *tabs),
                 f"{label}, edge shape T={T_e} S={S_e}")
            n_edge += 1
    print(f"edge shapes: B11 (G = {Y5}, G = 1) and B17 == plain on {n_edge} launches "
          "(S 1 / 200 / 1000 / 1040 / 4096, T 20 / 300 / 1000, ragged vend, overlap 0, "
          "every stream padded)", flush=True)

    # B6 (dense and bitap steps) and B13 at the edge shapes of their redesign
    # (one stream, S not a multiple of 128 or of 16, one word), with ragged
    # warm-ups and vends, with the plan's overlap and with none, and with
    # every stream padded.  Each launch's bitmap lands on memory filled with
    # ones just before (the caching allocator hands the freed blocks on), so
    # a word no segment writes would show.
    def poison(*shapes):
        for shape in shapes:
            torch.full(shape, -1, dtype=torch.int32, device=dev)

    n_edge = 0
    for T_e in EDGE_TS_WORDS:
        for S_e in (1, 200, 1000, 1040, 4096):
            for label, eng_b, st_b, src in (("bench needles, dense step", dense_eng, st, data),
                                            ("bench needles, bitap step", bitap_eng, st, data),
                                            ("config 2, comb16 step", eng2, st_c2, data2)):
                s_e, w_e, v_e = edge_streams(T_e, S_e, 8, 7 * T_e + S_e, src)
                z_e, pad = torch.zeros_like(s_e), torch.zeros_like(v_e)
                targs = eng_b.bits_args(st_b)[3:]
                name = "matchbits_comb16" if targs[0] == "comb16" else "matchbits"
                want = K.matchbits_plain(s_e, w_e, v_e, *targs)
                want_pad = K.matchbits_plain(z_e, w_e, pad, *targs)
                for streams_e, vend_e, over, ref, how in (
                        (s_e, v_e, st_b.plan.overlap, want, "plan's overlap"),
                        (s_e, v_e, None, want, "no overlap"),
                        (z_e, pad, st_b.plan.overlap, want_pad, "every stream padded")):
                    poison((S_e,), (T_e // 32, S_e))
                    got = K.matchbits(streams_e, w_e, vend_e, *targs, overlap=over)
                    for a, b, part in zip(got, ref, ("counts", "bitmap")):
                        same(name, a, b, f"{label}, {how}, edge shape T={T_e} S={S_e} {part}")
                    n_edge += 1
    print(f"edge shapes: B6 (dense, bitap steps) and B13 == plain on {n_edge} launches "
          f"(S 1 / 200 / 1000 / 1040 / 4096, T {' / '.join(map(str, EDGE_TS_WORDS))}, ragged "
          "warm and vend, the "
          "plan's overlap, none, every stream padded)", flush=True)

    # B1 and B2 at the edge shapes of their redesign: one stream, S not a
    # multiple of 128 or of 16, T below a tile, ragged warm-ups (and vends
    # for B1), with the plan's overlap, with none, and every stream padded
    # (zero bytes for B2, which has no vend); single bytes at their overlap
    # of 0; B1 at packing 1 and 2 and on NUL tables that are not zero-inert;
    # B2 on 1, 2, 3 and 8 words and on the trap layouts, with İ, Kelvin K and
    # ẞ written across the segment cuts.
    count_edge = []  # (wrapper, label, engine, needles)
    for label, needles, words in (("V = 1", NEEDLES, 1), ("V = 2", v2, 2),
                                  ("V = 3", v2 + ["hotel", "india", "juliett"], 3),
                                  ("V = 8", EIGHT_WORD_NEEDLES, 8), ("singles", ["a", "e", " ", "z"], 1)):
        m = machine_of(needles)
        e = BitapAcEngine(m, layout=plan_bitap(m, max_words=words), device=dev)
        check(e.bitap.n_words == words, f"B2 edge {label}: {e.bitap.n_words} words")
        count_edge.append(("bitap_count", label, e, needles))
    for label, needles, VT in (("embedded trap", ["kilo", "straße", "fix"], 1),
                               ("trap register", reg_needles, 2),
                               ("trap register, 2 words", TRAP_REGISTER_V3_NEEDLES, 3)):
        m = machine_of(needles)
        cm = case_dfa.compose_build(list(zip(m.needles, m.values)), machine=m)
        e = BitapAcEngine(cm, layout=plan_bitap_ci(cm, max_words=2), device=dev)
        check(e.bitap.has_trap and len(e.bitap.all_words()) == VT, f"B2 edge {label}: layout")
        count_edge.append(("bitap_count_trap", label, e, needles))
    for label, needles in (("packing 1", NEEDLES), ("packing 2", pk2),
                           ("NUL, not zero-inert", ["a\x00b", "\x00\x00", "xyz"]),
                           ("singles", ["a", "e", " ", "z"])):
        e = DenseAcEngine(machine_of(needles), device=dev)
        check((e.comp.packing == 2) == (label == "packing 2")
              and _zero_inert(e.machine) == (not label.startswith("NUL")),
              f"B1 edge {label}: packing {e.comp.packing}")
        count_edge.append(("dense_count", label, e, needles))

    srcs = {}
    n_edge, k_seen = 0, set()
    for T_e in EDGE_TS:
        for S_e in (1, 200, 1000, 1040, 4096):
            for name, label, e, needles in count_edge:
                if label not in srcs:
                    raw = synth_corpus([x for x in needles if "\x00" not in x], 1 << 18,
                                       hit_fraction=0.05, seed=len(srcs) + 60)
                    srcs[label] = scramble(raw, 7) if name == "bitap_count_trap" else (
                        np.frombuffer(raw, np.uint8))
                K_e = e.overlap
                s_e, w_e, v_e = edge_streams(T_e, S_e, K_e, 11 * T_e + S_e, srcs[label])
                if name == "dense_count":
                    t = e.tables
                    args = (s_e, t.classmap, t.table, w_e, v_e, t.packing, t.state_bits)
                    pad = (*args[:4], torch.zeros_like(v_e), *args[5:])
                    fn, plain = K.dense_count, K.dense_count_plain
                    k = dense_count_design(s_e, t.table, K_e).segments
                else:
                    t = e.bitap_tables
                    k = bitap_count_design(s_e, t.btab, t.field_bit, K_e).segments
                    if t.trapmask is not None:
                        a_e = s_e.cpu().numpy().copy()
                        plant_traps(a_e, k, K_e)
                        s_e = torch.from_numpy(a_e).to(dev)
                    args = (s_e, t.btab, t.seed, t.endmask, t.field_start, t.field_bit,
                            t.field_weight, w_e, t.trapmask)
                    pad = (torch.zeros_like(s_e), *args[1:])
                    fn, plain = K.bitap_count, K.bitap_count_plain
                k_seen.add(k)
                for a_e, over, how in ((args, K_e, f"plan's overlap {K_e}, k = {k}"),
                                       (args, None, "no overlap"),
                                       (pad, K_e, "every stream padded")):
                    got, want = fn(*a_e, overlap=over), plain(*a_e)
                    for a, b in zip(got if isinstance(got, tuple) else (got,),
                                    want if isinstance(want, tuple) else (want,)):
                        same(name, a, b, f"{label}, {how}, edge shape T={T_e} S={S_e}")
                    n_edge += 1
    print(f"edge shapes: B1 (packing 1 / 2, NUL, singles) and B2 (V = 1 / 2 / 3 / 8, singles, "
          f"embedded trap, trap register on 1 and 2 words) == plain on {n_edge} launches (S 1 / "
          f"200 / 1000 / 1040 / 4096, T {' / '.join(map(str, EDGE_TS))}, ragged warm and vend, the plan's overlap "
          f"(k in {sorted(k_seen)}), none, every stream padded; traps across the cuts)",
          flush=True)

    # B4 and B7 (with their trap parts) and B8 at the same edge shapes: the
    # rule's segments with the plan's overlap, then k = 1, 2, 3, 7, 16 and 64 forced, none,
    # and every stream padded (zero bytes for B4 and B7, vend 0 for B8); B4
    # and B7 on 1, 2 and 3 words and the trap layouts, with İ, Kelvin K and ẞ
    # written across the segment cuts; B8 on config 2, four count ranges, NUL, single bytes
    # (overlap 0) and a composed IgnoreCase machine.  The wrappers zero their
    # outputs, so no fill before a launch reaches the kernel.
    sticky_mod = sys.modules[K.bitap_contains.__module__]
    comb16_mod = sys.modules[K.comb16_count.__module__]
    ci16 = random_needles(47, 40) + ["straße", "kelvin"]
    m_ci16 = machine_of(ci16)
    b8_edge = [("config 2", c2, eng2)]
    for label, needles, m in (
            ("nested", ["a", "aa", "aaa", "aaaa", "aaaaa"] + random_needles(13, 80), None),
            ("NUL", c2[:60] + ["a\x00b", "\x00\x00x"], None),
            ("singles", ["a", "e", " ", "z"], None),
            ("IgnoreCase", ci16, case_dfa.compose_build(list(zip(m_ci16.needles, m_ci16.values)),
                                                        machine=m_ci16))):
        b8_edge.append((label, needles, Comb16AcEngine(m or machine_of(needles), device=dev)))
    check(b8_edge[-1][2].machine.composed_ci, "B8 edge IgnoreCase: not the composed machine")
    for label, needles, e in b8_edge:
        srcs["B8 " + label] = np.frombuffer(synth_corpus(
            [x for x in needles if "\x00" not in x], 1 << 18, hit_fraction=0.05,
            seed=len(srcs) + 60), np.uint8)
    # Forced segment counts: the ones that ``tests/test_torch_gpu.py``'s
    # ``FORCED_KS`` forces too, from one to the cap.
    forced_ks = (1, 2, 3, 7, 16, 64)

    def launch_at(mod, design, forced, fn):
        """``fn()`` with ``mod``'s design rule forced to ``forced`` segments
        (None: the rule's)."""
        if forced is None:
            return fn()
        with mock.patch.object(mod, design, lambda *a, **kw: Design(forced)):
            return fn()

    n_edge = {"bitap_contains": 0, "bitap_presence": 0, "comb16_count": 0}
    for T_e in EDGE_TS:
        for S_e in (1, 200, 1000, 1040, 4096):
            for name, label, e, needles in count_edge:
                if name == "dense_count" or len(e.bitap.all_words()) > sticky_mod.MAX_WORDS:
                    continue
                K_e, t = e.overlap, e.bitap_tables
                s_e, _, _ = edge_streams(T_e, S_e, K_e, 13 * T_e + S_e, srcs[label])
                if t.trapmask is not None:
                    a_e = s_e.cpu().numpy().copy()
                    plant_traps(a_e, bitap_contains_design(s_e, t.btab, K_e).segments, K_e)
                    s_e = torch.from_numpy(a_e).to(dev)
                args = (s_e, t.btab, t.seed, t.endmask, t.trapmask)
                # B4, then B7 (the same rule) on the same streams.
                for wrapper, design, plain, tag in (
                        (K.bitap_contains, "bitap_contains_design", K.bitap_contains_plain, "B4"),
                        (K.bitap_presence, "bitap_presence_design", K.bitap_presence_plain,
                         "B7")):
                    kname = wrapper.__name__
                    want = plain(*args)
                    for over, forced in ([(K_e, None), (None, None)]
                                         + [(K_e, f) for f in forced_ks]):
                        got = launch_at(sticky_mod, design, forced,
                                        lambda: wrapper(*args, overlap=over))
                        for a, b in zip(got if isinstance(got, tuple) else (got,),
                                        want if isinstance(want, tuple) else (want,)):
                            same(name.replace("bitap_count", kname), a, b,
                                 f"{label}, overlap {over}, k {forced or 'by the rule'}, edge "
                                 f"shape T={T_e} S={S_e}")
                        n_edge[kname] += 1
                    got = wrapper(torch.zeros_like(s_e), *args[1:], overlap=K_e)
                    check(not any(x.any() for x in (got if isinstance(got, tuple) else (got,))),
                          f"{tag} {label}: zero bytes flag a needle or a trap, edge shape "
                          f"T={T_e} S={S_e}")
                    n_edge[kname] += 1
            for label, needles, e in b8_edge:
                K_e = e.machine.max_needle_bytes - 1
                s_e, w_e, v_e = edge_streams(T_e, S_e, K_e, 17 * T_e + S_e, srcs["B8 " + label])
                args = (s_e, w_e, v_e, *e.tables.args())
                want = K.comb16_count_plain(*args)
                for over, forced in [(K_e, None), (None, None)] + [(K_e, f) for f in forced_ks]:
                    got = launch_at(comb16_mod, "comb16_count_design", forced,
                                    lambda: K.comb16_count(*args, overlap=over))
                    same("comb16_count", got, want,
                         f"{label}, overlap {over}, k {forced or 'by the rule'}, edge shape "
                         f"T={T_e} S={S_e}")
                    n_edge["comb16_count"] += 1
                pad = (*args[:2], torch.zeros_like(v_e), *args[3:])
                check(not K.comb16_count(*pad, overlap=K_e).any(),
                      f"B8 {label}: every stream padded counts, edge shape T={T_e} S={S_e}")
                n_edge["comb16_count"] += 1
    print(f"edge shapes: B4 and B7 (V = 1 / 2 / 3, singles, embedded trap, trap register on 1 "
          f"and 2 words) == plain on {n_edge['bitap_contains']} and {n_edge['bitap_presence']} "
          f"launches and B8 (config 2, nested, NUL, "
          f"singles, IgnoreCase) on {n_edge['comb16_count']} (S 1 / 200 / 1000 / 1040 / 4096, T "
          f"20 / 300 / 1000, the plan's overlap with the rule's k and k = {forced_ks}, none, every "
          f"stream padded; traps across the cuts)", flush=True)

    # B3 and B12 at the same edge shapes: the rule's segments with the plan's
    # overlap, then k = 1, 2, 3, 7, 16 and 64 forced, and none; B3 also over stream ranges
    # [s0, s1) whose s0 is not a multiple of 16 or whose s1 ends inside a
    # block, with every stream padded (vend 0 keeps the root entry), on
    # packing 1 and 2, NUL tables, single bytes and a composed IgnoreCase
    # machine (İ, Kelvin K and ẞ written across the segment cuts); B12 on the
    # full tables of B8's edge machines.  The wrappers fill B3's output with
    # the root entry, and B12 writes every entry.
    dense_mod = sys.modules[K.dense_contains.__module__]
    b3_edge = [(label, e, srcs[label]) for name, label, e, _ in count_edge
               if name == "dense_count"]
    ci3 = NEEDLES + ["kelvin", "straße"]
    m_ci3 = machine_of(ci3)
    e_ci3 = DenseAcEngine(case_dfa.compose_build(list(zip(m_ci3.needles, m_ci3.values)),
                                                 machine=m_ci3), device=dev)
    check(e_ci3.machine.composed_ci, "B3 edge IgnoreCase: not the composed machine")
    b3_edge.append(("IgnoreCase", e_ci3, scramble(synth_corpus(
        ci3, 1 << 18, hit_fraction=0.05, seed=71), 7)))
    n_edge = {"dense_contains": 0, "comb16_states": 0}
    b3_absorbed = 0
    for T_e in EDGE_TS:
        for S_e in (1, 200, 1000, 1040, 4096):
            for label, e, src in b3_edge:
                t = e.sticky_tables()
                K_e = t.min_overlap
                s_e, _, v_e = edge_streams(T_e, S_e, K_e, 19 * T_e + S_e, src)
                if label == "IgnoreCase":
                    a_e = s_e.cpu().numpy().copy()
                    plant_traps(a_e, dense_contains_design(s_e, t.table, K_e).segments, K_e)
                    s_e = torch.from_numpy(a_e).to(dev)
                for s0, s1 in sorted({(0, S_e), (min(3, S_e - 1), S_e), (0, max(1, S_e - 5)),
                                      (S_e // 3, min(S_e, S_e // 3 + 130))}):
                    args = (s_e, t.classmap, t.table, v_e, t.packing, t.state_bits, t.absorb, s0,
                            s1)
                    want = K.dense_contains_plain(*args)
                    b3_absorbed += int((want == t.absorb).sum())
                    for over, forced in [(K_e, None), (None, None)] + [(K_e, f) for f in forced_ks]:
                        got = launch_at(dense_mod, "dense_contains_design", forced,
                                        lambda: K.dense_contains(*args, overlap=over))
                        same("dense_contains", got, want,
                             f"{label}, [{s0}, {s1}), overlap {over}, k {forced or 'by the rule'}"
                             f", edge shape T={T_e} S={S_e}")
                        n_edge["dense_contains"] += 1
                    pad = (*args[:3], torch.zeros_like(v_e), *args[4:])
                    check(not K.dense_contains(*pad, overlap=K_e).any(),
                          f"B3 {label}: every stream padded left the root, edge shape T={T_e} "
                          f"S={S_e}")
                    n_edge["dense_contains"] += 1
            for label, needles, e in b8_edge:
                ft = e.full_tables
                K_e = e.machine.max_needle_bytes - 1
                s_e, _, _ = edge_streams(T_e, S_e, K_e, 23 * T_e + S_e, srcs["B8 " + label])
                args = (s_e, ft.classmap, ft.comb, ft.aux, ft.root_row, ft.segtable, ft.BB,
                        ft.owner_mask, ft.CB, ft.root_cb)
                want = K.comb16_states_plain(*args)
                for over, forced in [(K_e, None), (None, None)] + [(K_e, f) for f in forced_ks]:
                    got = launch_at(comb16_mod, "comb16_count_design", forced,
                                    lambda: K.comb16_states(*args, overlap=over))
                    same("comb16_states", got, want,
                         f"{label}, overlap {over}, k {forced or 'by the rule'}, edge shape "
                         f"T={T_e} S={S_e}")
                    n_edge["comb16_states"] += 1
    check(b3_absorbed > 0, "B3 edge shapes: no stream absorbed")
    print(f"edge shapes: B3 (packing 1 / 2, NUL, singles, IgnoreCase; ranges with s0 = 3 and "
          f"s1 inside a block; {b3_absorbed} absorbed entries) == plain on "
          f"{n_edge['dense_contains']} launches and B12 (config 2, nested, NUL, singles, "
          f"IgnoreCase full tables) on {n_edge['comb16_states']} (S 1 / 200 / 1000 / 1040 / "
          f"4096, T {' / '.join(map(str, EDGE_TS))}, the plan's overlap with the rule's k and k = {forced_ks}, "
          f"none, every stream padded)", flush=True)

    # B14 and B10 at the same edge shapes: the rule's segments with the
    # layout's restart (B14) or the plan's overlap (B10), then k = 1, 2, 3, 7, 16 and 64
    # forced, and none; odd vends (B14's last
    # pair reads a byte past vend), vend 0 and every stream padded.  B14 on
    # 0, 1, 3 and 12 words; B10 on B8's edge machines (config 2, nested, NUL,
    # singles, IgnoreCase).  The wrappers zero B14's output and fill B10's
    # with the root base.
    filter_mod = sys.modules[K.filter_contains.__module__]
    b14_edge = []
    for label, needles, words in (("V = 0", ["ab", "c", "xyz", "qq"], 3),
                                  ("V = 1", ["ab", "xyz", "qrstuvw"], 3),
                                  ("V = 3", c2, 3), ("V = 12", config5_needles(1000), 12)):
        m = machine_of(needles)
        fl = plan_filter(m, max_words=words)
        check(fl is not None and fl.n_words == int(label[4:]), f"B14 edge {label}: layout")
        b14_edge.append((label, needles, m, FilterTables.from_layout(fl, dev)))
        srcs["B14 " + label] = np.frombuffer(synth_corpus(needles, 1 << 18, hit_fraction=0.05,
                                                          seed=len(srcs) + 60), np.uint8)
    n_edge = {"filter_contains": 0, "comb16_contains": 0}
    odd_seen = 0
    for T_e in EDGE_TS:
        for S_e in (1, 200, 1000, 1040, 4096):
            for label, needles, m, tabs in b14_edge:
                K_e = m.max_needle_bytes - 1
                s_e, _, v_e = edge_streams(T_e, S_e, K_e, 29 * T_e + S_e, srcs["B14 " + label])
                odd_seen += int((v_e % 2 == 1).sum())
                args = (s_e, v_e, *tabs.args())
                want = K.filter_contains_plain(*args)
                for over, forced in [(K_e, None), (None, None)] + [(K_e, f) for f in forced_ks]:
                    got = launch_at(filter_mod, "filter_contains_design", forced,
                                    lambda: K.filter_contains(*args, over))
                    same("filter_contains", got, want,
                         f"{label}, overlap {over}, k {forced or 'by the rule'}, edge shape "
                         f"T={T_e} S={S_e}")
                    n_edge["filter_contains"] += 1
                pad = (s_e, torch.zeros_like(v_e), *tabs.args())
                check(not K.filter_contains(*pad, K_e).any(),
                      f"B14 {label}: every stream padded fired, edge shape T={T_e} S={S_e}")
                n_edge["filter_contains"] += 1
            for label, needles, e in b8_edge:
                t = e.sticky_tables()
                K_e = e.machine.max_needle_bytes - 1
                s_e, _, v_e = edge_streams(T_e, S_e, K_e, 31 * T_e + S_e, srcs["B8 " + label])
                args = (s_e, v_e, *t.sticky_args())
                want = K.comb16_contains_plain(*args)
                for over, forced in [(K_e, None), (None, None)] + [(K_e, f) for f in forced_ks]:
                    got = launch_at(comb16_mod, "comb16_count_design", forced,
                                    lambda: K.comb16_contains(*args, over))
                    same("comb16_contains", got, want,
                         f"{label}, overlap {over}, k {forced or 'by the rule'}, edge shape "
                         f"T={T_e} S={S_e}")
                    n_edge["comb16_contains"] += 1
                pad = (s_e, torch.zeros_like(v_e), *t.sticky_args())
                check(bool((K.comb16_contains(*pad, K_e) == t.root_cb).all()),
                      f"B10 {label}: every stream padded left the root, edge shape T={T_e} "
                      f"S={S_e}")
                n_edge["comb16_contains"] += 1
    check(odd_seen > 0, "B14 edge shapes: no odd vend")
    print(f"edge shapes: B14 (V = 0 / 1 / 3 / 12) == plain on "
          f"{n_edge['filter_contains']} launches and B10 (config 2, nested, NUL, singles, "
          f"IgnoreCase sticky tables) on {n_edge['comb16_contains']} (S 1 / 200 / 1000 / 1040 / "
          f"4096, T {' / '.join(map(str, EDGE_TS))}, {odd_seen} odd vends, the rule's k and k = {forced_ks}, "
          f"none, every stream padded)", flush=True)

    # B5 and B16 at the same edge shapes: the rule's segments with the plan's
    # overlap, then k = 1, 2, 3, 7, 16 and 64 forced, and none.  B5 on B3's edge machines'
    # full tables (packing 1 and 2, NUL, single bytes and the composed
    # IgnoreCase machine, İ, Kelvin K and ẞ written across the cuts) and on
    # zero bytes; B16 on config 5's 300, nested and NUL sets, single bytes
    # (overlap 0) and a composed IgnoreCase machine that the dispatcher sends
    # to comb32 (İ, Kelvin K and ẞ across the cuts), vend T and 0, every
    # stream padded (the root base).  B5 writes every entry of its output;
    # the wrapper fills B16's with the root base.
    states_mod = sys.modules[K.dense_states.__module__]
    comb_mod = sys.modules[K.comb_contains.__module__]
    ci32 = random_needles(47, 120) + ["straße", "kelvin"]
    m_ci32 = machine_of(ci32)
    cm_ci32 = case_dfa.compose_build(list(zip(m_ci32.needles, m_ci32.values)), machine=m_ci32)
    check(type(make_engine(cm_ci32, dev)) is CombAcEngine, "B16 edge IgnoreCase: not comb32")
    b16_edge = [("config 5's 300", n300, eng3)]
    for label, needles, m in (
            ("nested", ["a", "aa", "aaa", "aaaa", "aaaaa"] + random_needles(31, 120), None),
            ("NUL", random_needles(22, 200)[:150] + ["a\x00b", "\x00\x00x"], None),
            ("singles", ["a", "e", " ", "z"], singles),
            ("IgnoreCase", ci32, cm_ci32)):
        b16_edge.append((label, needles, CombAcEngine(m or machine_of(needles), device=dev)))
    for label, needles, _ in b16_edge:
        raw = synth_corpus([x for x in needles if "\x00" not in x], 1 << 18, hit_fraction=0.05,
                           seed=len(srcs) + 60)
        srcs["B16 " + label] = scramble(raw, 7) if label == "IgnoreCase" else (
            np.frombuffer(raw, np.uint8))
    n_edge = {"dense_states": 0, "comb_contains": 0}
    b16_absorbed = 0
    for T_e in EDGE_TS:
        for S_e in (1, 200, 1000, 1040, 4096):
            for label, e, src in b3_edge:
                t = e.tables
                K_e = t.min_overlap
                s_e, _, _ = edge_streams(T_e, S_e, K_e, 37 * T_e + S_e, src)
                if label == "IgnoreCase":
                    a_e = s_e.cpu().numpy().copy()
                    plant_traps(a_e, dense_states_design(s_e, t.table, K_e).segments, K_e)
                    s_e = torch.from_numpy(a_e).to(dev)
                args = (s_e, t.classmap, t.table, t.packing, t.state_bits)
                want = K.dense_states_plain(*args)
                for over, forced in [(K_e, None), (None, None)] + [(K_e, f) for f in forced_ks]:
                    got = launch_at(states_mod, "dense_states_design", forced,
                                    lambda: K.dense_states(*args, overlap=over))
                    same("dense_states", got, want,
                         f"{label}, overlap {over}, k {forced or 'by the rule'}, edge shape "
                         f"T={T_e} S={S_e}")
                    n_edge["dense_states"] += 1
                zero = torch.zeros_like(s_e)
                same("dense_states", K.dense_states(zero, *args[1:], overlap=K_e),
                     K.dense_states_plain(zero, *args[1:]),
                     f"{label}, zero bytes, edge shape T={T_e} S={S_e}")
                n_edge["dense_states"] += 1
            for label, needles, e in b16_edge:
                t = e.sticky_tables()
                K_e = t.min_overlap
                s_e, _, v_e = edge_streams(T_e, S_e, K_e, 41 * T_e + S_e, srcs["B16 " + label])
                if S_e > 2:
                    v_e[:2] = torch.tensor([T_e, 0], dtype=torch.int32, device=dev)
                if label == "IgnoreCase":
                    a_e = s_e.cpu().numpy().copy()
                    plant_traps(a_e, comb_count_design(s_e, t.comb, t.def_table, K_e).segments,
                                K_e)
                    s_e = torch.from_numpy(a_e).to(dev)
                args = (s_e, v_e, *t.sticky_args())
                want = K.comb_contains_plain(*args)
                b16_absorbed += int((want == t.absorb).sum())
                for over, forced in [(K_e, None), (None, None)] + [(K_e, f) for f in forced_ks]:
                    got = launch_at(comb_mod, "comb_count_design", forced,
                                    lambda: K.comb_contains(*args, over))
                    same("comb_contains", got, want,
                         f"{label}, overlap {over}, k {forced or 'by the rule'}, edge shape "
                         f"T={T_e} S={S_e}")
                    n_edge["comb_contains"] += 1
                pad = (s_e, torch.zeros_like(v_e), *t.sticky_args())
                check(bool((K.comb_contains(*pad, K_e) == t.root_base).all()),
                      f"B16 {label}: every stream padded left the root, edge shape T={T_e} "
                      f"S={S_e}")
                n_edge["comb_contains"] += 1
    check(b16_absorbed > 0, "B16 edge shapes: no stream absorbed")
    print(f"edge shapes: B5 (packing 1 / 2, NUL, singles, IgnoreCase full tables) == plain on "
          f"{n_edge['dense_states']} launches and B16 (config 5's 300, nested, NUL, singles, "
          f"IgnoreCase sticky tables; {b16_absorbed} absorbed bases) on "
          f"{n_edge['comb_contains']} (S 1 / 200 / 1000 / 1040 / 4096, T {' / '.join(map(str, EDGE_TS))}, the "
          f"plan's overlap with the rule's k and k = {forced_ks}, none, zero bytes, vend T and 0, "
          f"every stream padded)", flush=True)

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

    # The suffix screen (the main path's count) against B9 and the per-group
    # passes (the per-group control: one B15 or B8 launch per group), on the
    # config-5 corpus.
    check(eng5.count_staged(st5c) == want5["count_matches"], "grouped count after timing")
    screen5 = (st5c.streams, st5c.warm, st5c.vend, eng5._screen, st5c.plan.overlap)
    turns5 = []
    for label, fn in (("B9", lambda: eng5.stream_counts(st5c)),
                      ("screen", lambda: K.screen_count(*screen5)),
                      ("per-group", lambda: [e.stream_counts(st5c) for e in eng5.engines]),
                      ("per-group", lambda: [e.stream_counts(st5c) for e in eng5.engines]),
                      ("screen", lambda: K.screen_count(*screen5)),
                      ("B9", lambda: eng5.stream_counts(st5c))):
        turns5.append((label, timed(fn, KERNEL_RUNS)))
    b9 = [ms for label, ms in turns5 if label == "B9"]
    sc_turns = [ms for label, ms in turns5 if label == "screen"]
    b8s = [ms for label, ms in turns5 if label == "per-group"]
    print(f"time 1,000 needles, count: screen_count {sc_turns[0]:.4f} / {sc_turns[1]:.4f} ms, B9 "
          f"over {G5} uniform groups {b9[0]:.4f} / {b9[1]:.4f} ms, per-group passes over "
          f"{eng5.n_groups} groups {b8s[0]:.4f} / {b8s[1]:.4f} ms (turns B9, screen, per-group, "
          f"per-group, screen, B9; {card}); host C++ count {host_count_ms:.1f} ms host clock")

    # The extraction path's stages after the B6 kernel (bitap step).
    _, bits = K.matchbits(*bitap_eng.bits_args(st), overlap=st.plan.overlap)
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

    # -- the sharded engine on meshes of the card -------------------------------
    mesh_main, mesh_control, mesh_sites = mesh_phase(SimpleNamespace(
        dev=dev, card=card, zero_counts=zero_counts, read_counts=read_counts, tally=tally,
        run_ops=run_ops, same=same, timed=timed, bound=bound, table_bytes=table_bytes,
        corpus_bytes=CORPUS_BYTES, data=data, searcher=searcher, miss=miss, absent=absent,
        staged=staged, staged_miss=staged_miss, staged_absent=staged_absent, data_ci=data_ci,
        s_ci=s_ci, miss_ci=miss_ci, staged_ci=staged_ci, trap_hays=trap_hays, s100=s100,
        data2=data2, clean=clean, st2=st2))
    b11 = mesh_sites["comb16_contains_base"]
    timings[("comb16_contains_base", b11["what"])] = (
        b11["ms"], b11["plain_ms"], b11["bound_ms"], b11["bound_by"])

    # -- streaming past the device budget ---------------------------------------
    stream_main, stream_control = stream_phase(SimpleNamespace(
        dev=dev, card=card, zero_counts=zero_counts, read_counts=read_counts, tally=tally,
        timed=timed, scramble=scramble, searcher=searcher, dense_searcher=dense_searcher,
        miss=miss, miss_dense=miss_dense, miss_ci=miss_ci, s_ci=s_ci, s100=s100, s300=s300, s1000=s1000, s600=s600,
        n600=n600, n1000=n1000, last5=last5, data5=data5))

    # -- the tools: the CLI, the bench modules, the demo, the trace --------------
    tools_main = tools_phase(SimpleNamespace(
        dev=dev, card=card, zero_counts=zero_counts, read_counts=read_counts, tally=tally))

    # name: (source, TPU kernel it replaces, wrapper, the timing of its main path)
    table = {
        "bitap_count": ("bitap_count.cu", "bitap_scan.py:352", "bench needles"),
        "dense_count": ("dense_count.cu", "pallas_scan.py:281", "bench needles"),
        "dense_contains": ("dense_count.cu", "pallas_scan.py:426", "bench needles"),
        "bitap_contains": ("bitap_count.cu", "bitap_scan.py:466", "bench needles"),
        "matchbits": ("matchbits.cu", "pallas_scan.py:1174", "bench needles, bitap step"),
        "bitap_presence": ("bitap_count.cu", "bitap_scan.py:551", "bench needles"),
        "comb16_count": ("comb16_grouped.cu", "comb16_scan.py:610", "config 2"),
        "comb16_contains": ("comb16_grouped.cu", "comb16_scan.py:860",
                            "config 2, digits corpus: full scan"),
        "matchbits_comb16": ("comb16_grouped.cu", "comb16_scan.py:1382", "config 2, comb16 step"),
        "filter_contains": ("filter_contains.cu", "filter_scan.py:191", "config 2"),
        "comb16_count_grouped": ("comb16_grouped.cu", "comb16_scan.py:682", "config 5"),
        "screen_count": ("screen_count.cu", None, "config 5"),  # replaces no TPU kernel
        "comb16_contains_grouped": ("comb16_grouped.cu", "comb16_scan.py:778",
                                    "config 5, digits corpus: full scan"),
        "comb16_contains_base": ("comb16_grouped.cu", "comb16_scan.py:778", b11["what"]),
        "comb_count": ("comb_scan.cu", "comb_scan.py:389", "config 5, 300 needles"),
        "comb_contains": ("comb_scan.cu", "comb_scan.py:466",
                          "300 needles, digits corpus: full scan"),
        "comb_states": ("comb_scan.cu", "comb_scan.py:529", "config 5, 300 needles"),
        "dense_states": ("dense_count.cu", "pallas_scan.py:496", "bench needles"),
        "comb16_states": ("comb16_grouped.cu", "comb16_scan.py:917", "config 2"),
        "bitap_count_trap": ("bitap_count.cu", "bitap_scan.py:352",
                             "IgnoreCase bench needles, embedded trap"),
        "bitap_contains_trap": ("bitap_count.cu", "bitap_scan.py:466",
                                "IgnoreCase bench needles, embedded trap"),
        "bitap_presence_trap": ("bitap_count.cu", "bitap_scan.py:551",
                                "IgnoreCase bench needles, embedded trap"),
    }
    # Launches counted by the wrappers during the main paths, and apart from
    # them the controls'.
    launches, control = {}, {}
    for path in (bench_main, dense_main, c16_main, c32_main, g_main, states_main, extract_main,
                 ref_main, ci_main, mesh_main, api_main, stream_main, tools_main):
        tally(launches, path)
    for path in (bench_control, c16_control, g_control, ci_control, mesh_control,
                 stream_control):
        tally(control, path)
    kernels = []
    for name, (src, where, what) in table.items():
        ms, plain_ms, bms, by = timings[(name, what)]
        entry = {
            "name": name, "route": "cuda", "source": f"alfred_margaret_tpu_torch/csrc/{src}",
            "replaces": where and f"alfred_margaret_tpu/ops/{where}",
            "launches": launches.get(name, 0),
            "control_launches": control.get(name, 0),
            "api_launches": api_main.get(name, 0),  # Replacer, Splitter, adopt_staged
            "stream_launches": stream_main.get(name, 0),  # streamed past the budget
            "tools_launches": tools_main.get(name, 0),  # CLI, bench modules, demo, trace
            "max_abs_err": max_err[name], "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "library_ms": None,  # no PyTorch call runs an automaton
        }
        if (name, what) in designs:
            entry["design"] = designs[(name, what)]
        if name == "dense_contains":
            entry["ms_full_scan"], entry["plain_ms_full_scan"], entry["bound_ms_full_scan"], _ = (
                timings[(name, "miss needles, full scan")])
            entry["design_full_scan"] = designs[(name, "miss needles, full scan")]
            # The single-device main path's launches are contains_staged_early's
            # quarter ranges: its Excess at that shape, and the mesh's S6 at its
            # own (launches counts both).
            q_ms, q_plain, q_bound, _ = timings[(name, "30 needles, four quarter launches")]
            entry["ms_quarter"], entry["plain_ms_quarter"], entry["bound_ms_quarter"] = (
                q_ms / 4, q_plain / 4, q_bound / 4)
            entry["design_quarter"] = designs[(name, "30 needles, four quarter launches")]
            s6, n6 = mesh_sites[name], mesh_main.get(name, 0)
            entry["excess_ms"] = ((launches.get(name, 0) - n6) * (q_ms - q_bound) / 4
                                  + n6 * (s6["ms"] - s6["bound_ms"]))
        if name == "matchbits":
            entry["ms_dense_step"], entry["plain_ms_dense_step"], _, _ = timings[
                (name, "bench needles, dense step")]
            entry["design"] = matchbits_design(st.streams, *bitap_eng.bits_args(st)[3:],
                                               overlap=st.plan.overlap).as_dict()
            entry["design_dense_step"] = matchbits_design(
                st.streams, *dense_eng.bits_args(st)[3:], overlap=st.plan.overlap).as_dict()
            entry["ms_s8"] = mesh_sites["matchbits"]["ms"]  # the dense step on a shard
        if name == "matchbits_comb16":
            entry["design"] = matchbits_design(st_c2.streams, *eng2.bits_args(st_c2)[3:],
                                               overlap=st_c2.plan.overlap).as_dict()
        if name == "comb16_contains":
            entry["ms_first_match"], entry["plain_ms_first_match"], entry[
                "bound_ms_first_match"], _ = timings[(name, "config 2 corpus: stops at the first match")]
            entry["design_first_match"] = designs[(name, "config 2 corpus: stops at the first match")]
            # Every main-path launch decides a corpus on which no short needle
            # answers (the digits corpora, the composed machine): at the full
            # scan's shape.
            entry["excess_ms"] = launches.get(name, 0) * (ms - bms)
        if name == "comb16_count":
            entry["ms_30_needles"], entry["ms_30_needles_b1"] = b8, b1
        if name == "filter_contains":
            ms12, plain12, bound12, _ = timings[(name, "config 5, 12 words")]
            entry["ms_12_words"], entry["plain_ms_12_words"], entry["bound_ms_12_words"] = (
                ms12, plain12, bound12)
            entry["design_12_words"] = designs[(name, "config 5, 12 words")]
            # The comb16 path's launches at config 2's shape, the grouped
            # path's at config 5's.
            n12 = g_main.get(name, 0)
            entry["excess_ms"] = ((launches.get(name, 0) - n12) * (ms - bms)
                                  + n12 * (ms12 - bound12))
        if name == "comb16_count_grouped":
            entry.update(groups=G5, ms_turns=b9, ms_per_group_control=b8s,
                         per_group_passes=eng5.n_groups, host_cpp_count_ms=host_count_ms,
                         design=comb16_grouped_design(st5c.streams, f5,
                                                            st5c.plan.overlap).as_dict())
        if name == "screen_count":
            sc5 = eng5._screen
            sc5.passes.zero_()
            K.screen_count(st5c.streams, st5c.warm, st5c.vend, sc5, st5c.plan.overlap)
            entry.update(bits=sc5.bits, key_bytes=sc5.key_bytes, ms_turns=sc_turns,
                         pass_share=int(sc5.passes) / n_live_bytes(st5c),
                         design=screen_count_design(st5c.streams, sc5,
                                                    st5c.plan.overlap).as_dict())
        if name == "comb_states":
            t3 = eng3.full_tables
            entry["design"] = comb_count_design(st3c.streams, t3.comb, t3.def_table,
                                                st3c.plan.overlap).as_dict()
        if name == "comb_count":
            t3 = eng3.tables
            entry["design"] = comb_count_design(st3c.streams, t3.comb, t3.def_table,
                                                st3c.plan.overlap).as_dict()
        if name == "comb_contains":
            entry["ms_first_match"], entry["plain_ms_first_match"], entry[
                "bound_ms_first_match"], _ = timings[(name, "300 needles, config 5 corpus: first match")]
            entry["design_first_match"] = designs[(name, "300 needles, config 5 corpus: first match")]
            entry["warp_share_first_match"] = warp_share3
            # At the full scan's shape, as the rows of the earlier slices.
            entry["excess_ms"] = launches.get(name, 0) * (ms - bms)
        if name == "dense_states":
            entry["ms_packing2"], entry["plain_ms_packing2"], entry["bound_ms_packing2"], _ = (
                timings[(name, what30)])
            entry["packing2_what"] = what30
            entry["design_packing2"] = designs[(name, what30)]
            # The full launches at the bench needles' shape, S7's at its own.
            s7, n7 = mesh_sites[name], mesh_main.get(name, 0)
            entry["excess_ms"] = ((launches.get(name, 0) - n7) * (ms - bms)
                                  + n7 * (s7["ms"] - s7["bound_ms"]))
        if name in ("bitap_count_trap", "bitap_presence_trap"):
            entry["ms_trap_register"], entry["plain_ms_trap_register"], entry[
                "bound_ms_trap_register"], _ = timings[(name, "IgnoreCase 5 needles, trap register")]
        if name in ("bitap_count_trap", "bitap_presence_trap"):
            entry["design_trap_register"] = designs[(name, "IgnoreCase 5 needles, trap register")]
        if name == "comb16_contains_grouped":
            entry["groups"] = Y5
            entry["design"] = comb16_grouped_design(st5d.streams, y5,
                                                    st5d.plan.overlap).as_dict()
            entry["ms_first_match"], entry["plain_ms_first_match"], entry[
                "bound_ms_first_match"], _ = timings[(name, "config 5 corpus: stops at the first match")]
        if name in mesh_sites:  # its launches on the meshes, one shard's launch timed
            entry["mesh"] = dict(mesh_sites[name], launches=mesh_main.get(name, 0),
                                 control_launches=mesh_control.get(name, 0))
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
