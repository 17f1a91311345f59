"""The segmented schedules of the count kernels B1 (dense) and B2 (bitap,
with its trap part), ``alfred_margaret_tpu_torch/kernels/segments.py``,
which ``csrc/dense_count.cu`` and ``csrc/bitap_count.cu`` run on the card
(``csrc/stage.cuh``).

* The rules: one segment without an overlap, never a segment no longer than
  the overlap, and k = 16 at the main paths' shapes (128 MiB, S = 32768, and
  a 4096-stream mesh shard), with each kernel's shared memory; also for B4
  (the sticky bitap scan) and B8 (the comb16 count at config 2's tables).
* Exactness: the plain versions run over every segment of a schedule (B1
  through ``run_segments``, B2 through ``bitap_over_segments``: counts
  summed, trap planes OR-ed) equal the unsplit plain versions, and those
  equal the JAX kernels (``_make_count_kernel``, ``_make_bitap_count_kernel``)
  in interpret mode on the same staged corpus, two machines each; at k = 1,
  2, 3, 7, 16 and 64 with T = 40, not a multiple of 3, 7, 16 or 64; on
  stagings with stream 0, head streams warmed less than the overlap, fully
  padded streams and streams whose vend falls inside a later segment's
  warm-up; on NUL-bearing dense tables (packing 1 and 2), single bytes
  (overlap 0), a composed IgnoreCase machine, bitap layouts of 1, 2, 3 and 8
  words and the three trap layouts of ``test_torch_bitap_ci.py``, and trap
  tracks (İ, Kelvin K, ẞ) written across the cuts.
* The guard: ``BitapAcEngine`` and the mesh's S2 refuse a staging whose overlap is below
  the longest track (match or trap) less one.
* The plumbing: the dense and bitap engines, the trap recovery's B1 and the
  mesh's sites S1 and S2 pass the plan's overlap to the wrappers.

Tolerance: exact equality of every count and every trap word.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

from alfred_margaret_tpu.models import ac as jac
from alfred_margaret_tpu.models import case_dfa as jcase
from alfred_margaret_tpu.ops.bitap_scan import BitapAcEngine as JaxBitapAcEngine
from alfred_margaret_tpu.ops.bitap_scan import plan_bitap as jplan_bitap
from alfred_margaret_tpu.ops.bitap_scan import plan_bitap_ci as jplan_bitap_ci
from alfred_margaret_tpu.ops.pallas_scan import PallasAcEngine

from alfred_margaret_tpu_torch.kernels import segments as seg
from alfred_margaret_tpu_torch.kernels.bitap_count import bitap_count_plain
from alfred_margaret_tpu_torch.kernels.dense_count import dense_count_plain
from alfred_margaret_tpu_torch.models import ac, case_dfa
from alfred_margaret_tpu_torch.ops import bitap_scan, pallas_scan
from alfred_margaret_tpu_torch.ops.bitap_scan import (
    BitapAcEngine,
    BitapLayout,
    WordLayout,
    longest_track,
    plan_bitap,
    plan_bitap_ci,
)
from alfred_margaret_tpu_torch.ops.comb16_scan import Comb16AcEngine
from alfred_margaret_tpu_torch.ops.pallas_scan import DenseAcEngine, _zero_inert
from alfred_margaret_tpu_torch.parallel import DistributedAcEngine, make_mesh
from alfred_margaret_tpu_torch.parallel.shard import PLAIN

from test_torch_bitap_ci import _corpus
from test_torch_comb16 import CONFIG2
from test_torch_segments import CI, LONG_NUL, SINGLES, _layout_cases
from _torch_count_fixtures import (
    EMBEDDED_KSS, I_DOT, KELVIN, PACK2, REGISTER, REGISTER_V3, SHARP_S, V2, V3, V8, plant_traps)
from _torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

#: The wrappers' modules (``kernels`` exports the wrappers under their names).
bitap_mod = importlib.import_module("alfred_margaret_tpu_torch.kernels.bitap_count")
dense_mod = importlib.import_module("alfred_margaret_tpu_torch.kernels.dense_count")
sticky_mod = importlib.import_module("alfred_margaret_tpu_torch.kernels.bitap_contains")
comb16_mod = importlib.import_module("alfred_margaret_tpu_torch.kernels.comb16")
CPU = torch.device("cpu")
#: T = 40 steps on the stagings below: not a multiple of 3, 7, 16 or 64.
KW = dict(n_streams=128, t_tile=40)
KS = [1, 2, 3, 7, 16, 64]
NEEDLES3 = ["tshirt", "shirts", "shorts"]
#: Trap layouts: the three of test_torch_bitap_ci.py (with REGISTER), and
#: EMBEDDED_KSS and REGISTER_V3.
TRAPLESS = ["dress", "shoe", "shorts"]
EMBEDDED = ["kilo", "fix"]
#: Words that hold İ, Kelvin K and ẞ.
TRAPS = (f"K{I_DOT}LO", f"{KELVIN}ILO", f"F{I_DOT}X", f"STRA{SHARP_S}E")


def _machine(acmod, needles):
    return acmod.build([(n, i) for i, n in enumerate(needles)])


def _composed(acmod, cdmod, needles):
    m = _machine(acmod, needles)
    return cdmod.compose_build(list(zip(m.needles, m.values)), machine=m)


def _words_corpus(needles, n, seed):
    rng = np.random.default_rng(seed)
    words = [x.encode() for x in needles if "\x00" not in x]
    return (b" ".join(words[i] for i in rng.integers(0, len(words), n // 3)) + b"a\x00b" * 3)[:n]


# -- the rules ---------------------------------------------------------------------------


def test_count_designs_follow_the_rule(monkeypatch):
    # B2's shared memory mirrors bitap_count.cu's table_words and two tiles.
    assert seg.bitap_smem_bytes(1, 3) == 4 * 264 + 8192
    assert seg.bitap_smem_bytes(8, 240) == 4 * (2048 + 480) + 8192
    for smem in (seg.bitap_smem_bytes(1, 3), seg.bitap_smem_bytes(3, 12),
                 seg.bitap_smem_bytes(8, 240), seg.dense_bits_smem_bytes(128),
                 seg.dense_bits_smem_bytes(48 * 128)):
        # k = 16 at the main path's shape and on a (4,2,1) shard.
        assert seg.pick_segments(32768, 4224, 5, smem, 132) == 16
        assert seg.pick_segments(4096, 4224, 10, smem, 132) == 16
        # One segment without an overlap.
        assert seg.pick_segments(32768, 4224, None, smem, 132) == 1
        # Never a segment no longer than the overlap.
        for T, K in ((40, 19), (40, 5), (20, 10), (100, 0), (5, 0)):
            k = seg.pick_segments(128, T, K, smem, 132)
            assert k == 1 or T // k > K
    # The wrappers take these rules with their kernels' shared memory.
    monkeypatch.setattr(bitap_mod, "sm_count", lambda _dev: 132)
    monkeypatch.setattr(dense_mod, "sm_count", lambda _dev: 132)
    streams = torch.zeros(4224, 4096, dtype=torch.uint8)
    btab, fbit = torch.zeros(2, 256, dtype=torch.int32), torch.zeros(5, dtype=torch.int32)
    table = torch.zeros(200, dtype=torch.int32)
    assert bitap_mod.bitap_count_design(streams, btab, fbit, 6).segments == seg.pick_segments(
        4096, 4224, 6, seg.bitap_smem_bytes(2, 5), 132) == 16
    assert bitap_mod.bitap_count_design(streams, btab, fbit).segments == 1
    assert dense_mod.dense_count_design(streams, table, 6).as_dict() == {
        "k": 16, "t_tile": seg.T_TILE, "Gc": 1}
    assert dense_mod.dense_count_design(streams[:20], table, 10).segments == 1
    # B4 (B2's sticky mode: its masks, no fields) and B8 (B9's rule for one
    # group, at config 2's table size), at the full width and on a shard.
    monkeypatch.setattr(sticky_mod, "sm_count", lambda _dev: 132)
    monkeypatch.setattr(comb16_mod, "sm_count", lambda _dev: 132)
    assert seg.bitap_smem_bytes(1, 0) == 4 * 256 + 8192
    c2 = Comb16AcEngine(_machine(ac, CONFIG2), device=CPU, n_streams=8, t_tile=8).tables
    cw, aw = c2.comb.numel(), c2.aux.numel()
    for S in (32768, 4096):
        wide = torch.zeros(4224, S, dtype=torch.uint8)
        for V in (1, 2, 3):
            d = sticky_mod.bitap_contains_design(wide, torch.zeros(V, 256, dtype=torch.int32), 5)
            assert d.segments == seg.pick_segments(
                S, 4224, 5, seg.bitap_smem_bytes(V, 0), 132) == 16
        d = comb16_mod.comb16_count_design(wide, c2.comb, c2.aux, 7)
        assert d.as_dict() == {"k": 16, "t_tile": seg.T_TILE, "Gc": 1}
        assert d == seg.grouped_design(S, 4224, 7, 1, cw, aw, 132)
    assert sticky_mod.bitap_contains_design(streams, btab).segments == 1
    assert comb16_mod.comb16_count_design(streams, c2.comb, c2.aux).segments == 1


# -- B1 over the schedule -----------------------------------------------------------------


def _b1(streams, warm, vend, classmap, table, packing, state_bits):
    return dense_count_plain(streams, classmap, table, warm, vend, packing, state_bits)


#: name: (needles, corpus bytes, composed, held against the JAX kernel)
B1_CASES = {
    "long_nul": (LONG_NUL, 1000, False, True),
    "packing2_nul": (PACK2 + ["a\x00b"], 1100, False, True),
    "singles": (SINGLES, 1500, False, False),
    "ignorecase": (CI, 1300, True, False),
}
_B1 = {}


def _b1_case(name):
    """(JAX counts or None, the port's staging, B1's args without the
    overlap) of a case, built once."""
    if name not in _B1:
        needles, n, composed, jax = B1_CASES[name]
        tm = _machine(ac, needles)
        if composed:
            tm = case_dfa.compose_build(list(zip(tm.needles, tm.values)), machine=tm)
        eng = DenseAcEngine(tm, device=CPU, **KW)
        hay = _words_corpus(needles, n, len(name))
        if composed:  # raw bytes in mixed case
            a = np.frombuffer(hay, np.uint8).copy()
            a[(a >= 97) & (a <= 122) & (np.random.default_rng(1).random(len(a)) < 0.5)] -= 32
            hay = a.tobytes()
        data = np.frombuffer(hay, np.uint8)
        pst = eng.stage(data)
        want = None
        if jax:
            jeng = PallasAcEngine(_machine(jac, needles), interpret=True, **KW)
            st = jeng.stage(data)
            np.testing.assert_array_equal(pst.warm_np, np.asarray(st.warm_np).reshape(-1))
            want = np.asarray(jeng._get_count_fn(st.plan.time_len)(
                jeng._bscal_for(st), jeng._classmap_dev, jeng._table_dev, st.warm_t, st.vend_t,
                st.streams_dev)).reshape(-1)
        args = eng._kernel_args(pst)
        assert args[-1] == pst.plan.overlap
        _B1[name] = (want, pst, eng, args[:-1])
    return _B1[name]


@pytest.mark.parametrize("name", list(B1_CASES))
@pytest.mark.parametrize("k", KS)
def test_b1_segments_equal_unsplit_and_jax(name, k):
    want, pst, eng, args = _b1_case(name)
    streams, classmap, table, warm, vend, packing, state_bits = args
    K, T, live = pst.plan.overlap, pst.plan.time_len, pst.live_np
    assert T == 40
    cases = _layout_cases(pst)
    assert cases["stream 0"] and cases["padded"]
    if name == "long_nul":
        assert K == 19 and cases["short warm-up"] and not _zero_inert(eng.machine)
    if name == "packing2_nul":
        assert eng.comp.packing == 2 and not _zero_inert(eng.machine)
    if name == "singles":
        assert K == 0
    whole = dense_count_plain(*args)
    if want is not None:
        np.testing.assert_array_equal(whole.numpy()[live], want[live])
    got = seg.run_segments(_b1, streams, warm, vend, classmap, table, packing, state_bits,
                           overlap=K, segments=k)
    assert got.dtype == torch.int32 and torch.equal(got, whole)
    assert int(got.sum()) > 0
    assert eng.count_staged(pst) == int(got.numpy()[live].astype(np.int64).sum())
    if name == "long_nul" and k == 2:
        # Streams whose vend lies inside the second segment's warm-up count
        # nothing there, and still all their matches.
        start, lo, _ = seg.segment_schedule(T, k, K)[1]
        assert ((vend.numpy() > start) & (vend.numpy() <= lo)).any()


# -- B2 over the schedule -----------------------------------------------------------------

#: name: (needles, words, composed, held against the JAX kernel, layout:
#: (match words, embedded trap, trap register))
B2_CASES = {
    "v1": (NEEDLES3, 2, False, False, (1, False, False)),
    "v2": (V2, 2, False, True, (2, False, False)),
    "v3": (V3, 3, False, False, (3, False, False)),
    "v8": (V8, 8, False, False, (8, False, False)),
    "trapless": (TRAPLESS, 2, True, False, (1, False, False)),
    "embedded_trap": (EMBEDDED, 2, True, True, (1, True, False)),
    "trap_register": (REGISTER, 2, True, False, (1, False, True)),
}
_B2 = {}


def _b2_case(name):
    """(JAX output or None, the port's staging, the engine, B2's args
    without the overlap) of a case, built once."""
    if name not in _B2:
        needles, words, composed, jax, _ = B2_CASES[name]
        if composed:
            tm = _composed(ac, case_dfa, needles)
            lay = plan_bitap_ci(tm, max_words=words)
            hay = _corpus(needles, 400, 3, traps=[(300, TRAPS[0]), (900, TRAPS[1]),
                                                  (1500, TRAPS[2])])
        else:
            tm = _machine(ac, needles)
            lay = plan_bitap(tm, max_words=words)
            hay = _words_corpus(needles, 1300, 7)
        eng = BitapAcEngine(tm, layout=lay, device=CPU, **KW)
        data = np.frombuffer(hay, np.uint8)
        pst = eng.stage(data)
        want = None
        if jax:
            if composed:
                jm = _composed(jac, jcase, needles)
                jlay = jplan_bitap_ci(jm, max_words=words)
            else:
                jm = _machine(jac, needles)
                jlay = jplan_bitap(jm, max_words=words)
            jeng = JaxBitapAcEngine(jm, layout=jlay, interpret=True, **KW)
            st = jeng.stage(data)
            np.testing.assert_array_equal(pst.warm_np, np.asarray(st.warm_np).reshape(-1))
            out = jeng._get_bitap_count_fn(st.plan.time_len)(
                jeng._bscal_for(st), jeng._btab_dev, st.warm_t, st.streams_dev)
            want = tuple(np.asarray(o).reshape(-1) for o in (out if lay.has_trap else (out,)))
        args = eng._kernel_args(pst)
        assert args[-1] == pst.plan.overlap
        _B2[name] = (want, pst, eng, args[:-1])
    return _B2[name]


def _pair(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("name", list(B2_CASES))
@pytest.mark.parametrize("k", KS)
def test_b2_segments_equal_unsplit_and_jax(name, k):
    want, pst, eng, args = _b2_case(name)
    lay = eng.bitap
    shape = B2_CASES[name][4]
    assert (lay.n_words, any(w.trap_endmask for w in lay.words), lay.trap is not None) == shape
    K, T, live = pst.plan.overlap, pst.plan.time_len, pst.live_np
    assert T == 40 and K >= eng.bitap_tables.max_track_bytes - 1
    cases = _layout_cases(pst)
    assert cases["stream 0"] and cases["padded"]
    streams, tables, warm, trapmask = args[0], args[1:7], args[7], args[8]
    whole = _pair(bitap_count_plain(*args))
    if want is not None:
        for g, w in zip(whole, want):
            np.testing.assert_array_equal(g.numpy()[live], w[live])
    got = _pair(seg.bitap_over_segments(bitap_count_plain, streams, tables, warm, trapmask,
                                        overlap=K, segments=k))
    assert len(got) == len(whole) == 1 + lay.has_trap
    for g, w in zip(got, whole):
        assert g.dtype == torch.int32 and torch.equal(g, w)
    assert int(got[0].sum()) > 0
    if lay.has_trap:
        assert got[1].any()  # the traps fired


@pytest.mark.parametrize("needles,traps,k", [
    (EMBEDDED_KSS, (I_DOT, KELVIN, SHARP_S), 2), (EMBEDDED_KSS, (I_DOT, KELVIN, SHARP_S), 7),
    (REGISTER_V3, (I_DOT, KELVIN), 3), (REGISTER_V3, (I_DOT, KELVIN), 16)])
def test_b2_trap_tracks_across_cuts(needles, traps, k):
    """Trap encodings written across each cut p_i, in a few streams each:
    the segment that owns p_i reads the whole encoding in its warm-up and
    own range, so the OR of the segments' traps is the unsplit trap plane."""
    tm = _composed(ac, case_dfa, needles)
    lay = plan_bitap_ci(tm, max_words=2)
    assert lay.has_trap and (len(lay.all_words()) == 3) == (needles is REGISTER_V3)
    eng = BitapAcEngine(tm, layout=lay, device=CPU, n_streams=64, t_tile=32)
    K = eng.overlap
    T, S = 96, 48
    rng = np.random.default_rng(k)
    letters = np.frombuffer("".join(needles).lower().encode(), np.uint8)
    a = rng.choice(letters[letters < 128], size=(T, S)).astype(np.uint8)
    planted = plant_traps(a, k, K, traps)  # each encoding straddles a cut p_i
    assert len(planted) == (k - 1) * len(traps)
    streams = torch.from_numpy(np.ascontiguousarray(a))
    warm = torch.from_numpy(rng.integers(0, K + 1, S).astype(np.int32))
    t = eng.bitap_tables
    tables = (t.btab, t.seed, t.endmask, t.field_start, t.field_bit, t.field_weight)
    counts, trap = bitap_count_plain(streams, *tables, warm, t.trapmask)
    assert trap[planted].all()
    got = seg.bitap_over_segments(bitap_count_plain, streams, tables, warm, t.trapmask,
                                  overlap=K, segments=k)
    assert torch.equal(got[0], counts) and torch.equal(got[1], trap)


# -- the guard ------------------------------------------------------------------------------


def test_longest_track_counts_match_and_trap_tracks():
    assert longest_track(plan_bitap(_machine(ac, NEEDLES3))) == 6
    assert longest_track(plan_bitap_ci(_composed(ac, case_dfa, ["straße"]))) == 7
    # A trap track longer than every match track: bits 4..8 of the word,
    # and a standalone register whose one track runs over bits 0..5.
    word = WordLayout(seed=0b1 | 1 << 4, endmask=0b10, btab=np.zeros(256, np.int64),
                      fields=((1, 2, 1),), trap_endmask=1 << 8)
    assert longest_track(BitapLayout(words=(word,), unroll=1)) == 5
    reg = WordLayout(seed=1, endmask=1 << 5, btab=np.zeros(256, np.int64), fields=())
    assert longest_track(BitapLayout(words=(word,), unroll=1, trap=reg)) == 6


def test_overlap_below_the_longest_track_raises():
    eng = BitapAcEngine(_machine(ac, NEEDLES3), device=CPU, n_streams=8, t_tile=8)
    st = eng.stage(b"tshirts and shorts " * 8)
    assert eng.bitap_tables.max_track_bytes == 6 and st.plan.overlap == 5
    short = dataclasses.replace(st, plan=dataclasses.replace(st.plan, overlap=4))
    with pytest.raises(ValueError, match="longest track"):
        eng._kernel_args(short)
    with pytest.raises(ValueError, match="longest track"):
        eng.count_staged(short)
    # At the longest track less one the segments are exact.
    assert eng.count_staged(st) == ac.count_matches(eng.machine, b"tshirts and shorts " * 8)
    # A composed machine: its plan covers every match and trap track.
    ci = BitapAcEngine(_composed(ac, case_dfa, EMBEDDED_KSS), device=CPU, n_streams=8, t_tile=8,
                       layout=plan_bitap_ci(_composed(ac, case_dfa, EMBEDDED_KSS)))
    assert ci.overlap >= ci.bitap_tables.max_track_bytes - 1 == 6


def test_mesh_overlap_below_the_longest_track_raises():
    """The mesh's S2 builds its own tables and holds them to the same guard."""
    m = _machine(ac, NEEDLES3)
    eng = DistributedAcEngine(m, make_mesh(["cpu"] * 8, data=4, seq=2), inner="pallas")
    hay = b"tshirts and shorts " * 200
    staged = eng.stage(hay)
    assert staged.plan.overlap == 5
    short = dataclasses.replace(staged, plan=dataclasses.replace(staged.plan, overlap=4))
    i, g, dev = next(iter(eng.shards()))
    with pytest.raises(ValueError, match="longest track"):
        eng.shard_call("count", short, i, g, dev, use_bitap=True)
    with pytest.raises(ValueError, match="shorter warm-up"):  # the mesh's own staging check
        eng.count(short)
    # The dense route (S1) takes no bitap layout and so no guard.
    eng.shard_call("count", short, i, g, dev, use_bitap=False)
    assert eng.count(staged) == ac.count_matches(m, hay)


# -- the plumbing -----------------------------------------------------------------------------


def _spy(monkeypatch, module, name, pos, seen):
    """Record the ``overlap`` each call of ``module.name`` passes (the
    positional argument ``pos`` or the keyword)."""
    real = getattr(module, name)

    def spy(*a, **kw):
        seen.append(a[pos] if len(a) > pos else kw.get("overlap"))
        return real(*a, **kw)

    monkeypatch.setattr(module, name, spy)


def test_engines_pass_the_plans_overlap(monkeypatch):
    seen_dense, seen_bitap, seen_recovery = [], [], []
    _spy(monkeypatch, pallas_scan, "dense_count", 7, seen_dense)
    _spy(monkeypatch, bitap_scan, "bitap_count", 9, seen_bitap)
    _spy(monkeypatch, bitap_scan, "dense_count", 7, seen_recovery)
    m = _machine(ac, NEEDLES3)
    hay = b"tshirts and shorts " * 40
    dense = DenseAcEngine(m, device=CPU, n_streams=16, t_tile=8)
    st = dense.stage(hay)
    assert dense.count_staged(st) == ac.count_matches(m, hay)
    assert seen_dense == [st.plan.overlap] == [5]
    bitap = BitapAcEngine(m, device=CPU, n_streams=16, t_tile=8)
    assert bitap.count_staged(st) == ac.count_matches(m, hay)
    assert seen_bitap == [5]
    # The trap recovery's B1: no host corpus, so the dense re-scan.
    ci = BitapAcEngine(_composed(ac, case_dfa, EMBEDDED), device=CPU, n_streams=16, t_tile=8,
                       layout=plan_bitap_ci(_composed(ac, case_dfa, EMBEDDED)))
    sci = ci.stage("kilo KİLO fix ".encode() * 30)
    sci.data_np = None
    assert ci.count_staged(sci) == ac.count_matches(ci.machine, "kilo KİLO fix ".encode() * 30)
    assert seen_bitap[1:] == [sci.plan.overlap] and seen_recovery == [sci.plan.overlap]


@pytest.mark.parametrize("use_bitap,kernel", [(True, "bitap_count"), (False, "dense_count")])
def test_mesh_count_sites_pass_the_plans_overlap(use_bitap, kernel):
    m = _machine(ac, NEEDLES3)
    eng = DistributedAcEngine(m, make_mesh(["cpu"] * 8, data=4, seq=2), inner="pallas")
    hay = b"tshirts and shorts " * 200
    staged = eng.stage(hay)
    for i, g, dev in eng.shards():
        fn, args, kw = eng.shard_call("count", staged, i, g, dev, use_bitap=use_bitap)
        assert fn.__name__ == kernel and kw == {"overlap": staged.plan.overlap}
        assert torch.equal(fn(*args, **kw), PLAIN[fn](*args, **kw))
    assert eng.count(staged) == ac.count_matches(m, hay)
