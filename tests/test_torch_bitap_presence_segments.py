"""The segmented schedule of B7, the bitap presence scan ``bitap_presence``
with its trap part, which ``csrc/bitap_count.cu`` runs on the card as the
presence mode of B2's scan (``csrc/stage.cuh``).

* Exactness: B7's plain version run over every segment of a schedule from
  its scan start, each word's plane OR-ed (``or_over_segments`` of
  ``alfred_margaret_tpu_torch/kernels/segments.py``), equals the unsplit
  plain version, and that equals the JAX kernel
  (``_make_bitap_presence_kernel``) in interpret mode on the same staged
  corpus, at k = 1, 2, 3 and 5 with T = 160; on the bench needles (one
  word), the two-word set of ``chip_smoke.py``, an IgnoreCase layout with a
  trap embedded in its match word and the trap-register layouts beside one
  word and beside two; on stagings with stream 0, fully padded streams and
  streams with no needle; the per-needle presence equals the JAX engine's.
  And with the trap tracks of İ, Kelvin K and ẞ and an upper-case needle
  written across every cut.
* The guard: ``BitapAcEngine.presence_args`` and ``needle_presence_staged``
  refuse a staging whose overlap is below the longest track (match or trap)
  less one, before any launch.
* The plumbing: ``needle_presence_staged`` passes the plan's overlap to the
  wrapper; B7 takes B4's design rule.

Tolerance: exact equality of every plane word and presence flag.
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

from alfred_margaret_tpu_torch.kernels import segments as seg
from alfred_margaret_tpu_torch.kernels.bitap_contains import bitap_presence, bitap_presence_plain
from alfred_margaret_tpu_torch.models import ac, case_dfa
from alfred_margaret_tpu_torch.ops import bitap_scan
from alfred_margaret_tpu_torch.ops.bitap_scan import BitapAcEngine, plan_bitap, plan_bitap_ci

from test_torch_bitap_ci import _scramble
from test_torch_count_segments import EMBEDDED, NEEDLES3, TRAPS, _composed, _machine, _spy
from test_torch_segments import _layout_cases
from test_torch_sticky_bitap_segments import _sparse_corpus
from _torch_count_fixtures import (
    EMBEDDED_KSS, I_DOT, KELVIN, REGISTER, REGISTER_V3, SHARP_S, V2, plant_traps)
from _torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

CPU = torch.device("cpu")
sticky_mod = importlib.import_module("alfred_margaret_tpu_torch.kernels.bitap_contains")
#: 128 streams of 160 steps (T a multiple of the tile of 40), the last
#: one fully padded: 127 streams of 120 bytes.
KW = dict(n_streams=128, t_tile=40)
CORPUS_BYTES = 127 * 120
KS = [1, 2, 3, 5]

#: name: (needles, composed, layout: (match words, embedded trap, trap
#: register)).  V2 is ``chip_smoke.py``'s TWO_WORD_NEEDLES, REGISTER and
#: REGISTER_V3 its TRAP_REGISTER_NEEDLES and TRAP_REGISTER_V3_NEEDLES.
B7_CASES = {
    "bench": (NEEDLES3, False, (1, False, False)),
    "two_words": (V2, False, (2, False, False)),
    "embedded_trap": (EMBEDDED, True, (1, True, False)),
    "trap_register": (REGISTER, True, (1, False, True)),
    "trap_register_v3": (REGISTER_V3, True, (2, True, True)),
}
_B7 = {}


def _b7_case(name):
    """(the JAX planes and presence, the port's staging, the engine, B7's
    args) of a case, built once."""
    if name not in _B7:
        needles, composed, _ = B7_CASES[name]
        if composed:
            tm = _composed(ac, case_dfa, needles)
            lay = plan_bitap_ci(tm, max_words=2)
            hay = _scramble(_sparse_corpus(needles, CORPUS_BYTES + 16, 5), 5)
            for pos, trap in ((3000, TRAPS[0]), (9000, TRAPS[1]), (15000, TRAPS[3])):
                hay = hay[:pos] + trap.encode() + hay[pos:]
            hay = hay[:CORPUS_BYTES]
            jm = _composed(jac, jcase, needles)
            jlay = jplan_bitap_ci(jm, max_words=2)
        else:
            tm = _machine(ac, needles)
            lay = plan_bitap(tm, max_words=2)
            hay = _sparse_corpus(needles, CORPUS_BYTES + 16, 17)[:CORPUS_BYTES]
            jm = _machine(jac, needles)
            jlay = jplan_bitap(jm, max_words=2)
        eng = BitapAcEngine(tm, layout=lay, device=CPU, **KW)
        data = np.frombuffer(hay, np.uint8)
        assert len(data) == CORPUS_BYTES
        pst = eng.stage(data)
        jeng = JaxBitapAcEngine(jm, layout=jlay, interpret=True, **KW)
        st = jeng.stage(data)
        np.testing.assert_array_equal(pst.live_np, np.asarray(st.live_np).reshape(-1))
        VT = len(lay.all_words())
        planes = jeng._get_bitap_presence_fn(st.plan.time_len)(jeng._btab_dev, st.streams_dev)
        want = (np.asarray(planes).reshape(VT, -1), jeng.needle_presence_staged(st))
        args = eng.presence_args(pst)
        assert args[-1] == pst.plan.overlap
        _B7[name] = (want, pst, eng, args)
    return _B7[name]


@pytest.mark.parametrize("name", list(B7_CASES))
@pytest.mark.parametrize("k", KS)
def test_b7_segments_equal_unsplit_and_jax(name, k):
    (want_planes, want_pres), pst, eng, args = _b7_case(name)
    lay = eng.bitap
    assert (lay.n_words, any(w.trap_endmask for w in lay.words),
            lay.trap is not None) == B7_CASES[name][2]
    streams, btab, seed, endmask, trapmask, K = args
    T, S = streams.shape
    VT = btab.shape[0]
    assert T == 160 and K >= eng.bitap_tables.max_track_bytes - 1 and T // k > K
    assert _layout_cases(pst)["stream 0"] and _layout_cases(pst)["padded"]
    whole = bitap_presence_plain(*args)
    assert whole.dtype == torch.int32 and whole.shape == (VT, S)
    np.testing.assert_array_equal(whole.numpy(), want_planes)
    got = seg.or_over_segments(bitap_presence_plain, streams, (btab, seed, endmask), trapmask,
                               overlap=K, segments=k)
    assert got.dtype == torch.int32 and got.shape == (VT, S) and torch.equal(got, whole)
    # Streams with a needle and streams without one.
    any_word = (got != 0).any(0)
    assert 0 < int(any_word.sum()) < int(pst.live_np.sum())
    if lay.has_trap:
        # The traps fired, in the word's plane or the register's.
        tbits = [int(w.trap_endmask) for w in lay.words] + [-1] * (lay.trap is not None)
        assert any(bool((got[w] & t).any()) for w, t in enumerate(tbits))
    # The wrapper on the CPU runs the plain version, whatever the overlap.
    assert torch.equal(bitap_presence(*args), whole)
    # Per needle, as the JAX engine reads it (None where a trap fired).
    pres = eng.needle_presence_staged(pst)
    if want_pres is None:
        assert pres is None and lay.has_trap
    else:
        assert pres.dtype == bool and pres.any()
        np.testing.assert_array_equal(pres, want_pres)


@pytest.mark.parametrize("needles,traps,k", [
    (EMBEDDED_KSS, (I_DOT, KELVIN, SHARP_S), 2), (EMBEDDED_KSS, (I_DOT, KELVIN, SHARP_S), 5),
    (REGISTER, (I_DOT, KELVIN), 3), (REGISTER_V3, (I_DOT, KELVIN), 7)])
def test_b7_trap_tracks_across_cuts(needles, traps, k):
    """Trap encodings (in the first half of the streams) and an upper-case
    needle (in the second half) written across each cut p_i: the segment
    that owns p_i reads the whole encoding in its warm-up and own range, so
    the OR of the segments' planes is the unsplit scan's."""
    tm = _composed(ac, case_dfa, needles)
    lay = plan_bitap_ci(tm, max_words=2)
    assert lay.has_trap and (lay.trap is not None) == (needles is not EMBEDDED_KSS)
    eng = BitapAcEngine(tm, layout=lay, device=CPU, n_streams=64, t_tile=32)
    K = eng.overlap
    T, S = 96, 96
    rng = np.random.default_rng(k)
    letters = np.frombuffer("".join(needles).lower().encode(), np.uint8)
    a = rng.choice(letters[letters < 128], size=(T, S)).astype(np.uint8)
    planted = plant_traps(a[:, :S // 2], k, K, traps)
    assert len(planted) == (k - 1) * len(traps)
    word = needles[0].upper()
    hit = [S // 2 + s for s in plant_traps(a[:, S // 2:], k, K, (word,))]
    streams = torch.from_numpy(np.ascontiguousarray(a))
    t = eng.bitap_tables
    tables = (t.btab, t.seed, t.endmask)
    whole = bitap_presence_plain(streams, *tables, t.trapmask)
    trap = torch.zeros(S, dtype=torch.bool)
    for w, wl in enumerate(lay.words):
        trap |= (whole[w] & int(wl.trap_endmask)) != 0
    if lay.trap is not None:
        trap |= whole[lay.n_words] != 0
    ends = (whole[:lay.n_words] & t.endmask[:lay.n_words, None]).any(0)
    assert trap[planted].all() and ends[hit].all()
    got = seg.or_over_segments(bitap_presence_plain, streams, tables, t.trapmask, overlap=K,
                               segments=k)
    assert torch.equal(got, whole)


# -- the guard ------------------------------------------------------------------------------


def test_b7_overlap_below_the_longest_track_raises_before_a_launch(monkeypatch):
    calls = []
    _spy(monkeypatch, bitap_scan, "bitap_presence", 5, calls)
    eng = BitapAcEngine(_machine(ac, NEEDLES3), device=CPU, n_streams=8, t_tile=8)
    st = eng.stage(b"tshirt and shorts " * 8)
    assert eng.bitap_tables.max_track_bytes == 6 and st.plan.overlap == 5
    short = dataclasses.replace(st, plan=dataclasses.replace(st.plan, overlap=4))
    with pytest.raises(ValueError, match="longest track"):
        eng.presence_args(short)
    with pytest.raises(ValueError, match="longest track"):
        eng.needle_presence_staged(short)
    assert calls == []
    # At the longest track less one the segments are exact.
    np.testing.assert_array_equal(eng.needle_presence_staged(st), [True, False, True])
    assert calls == [5]
    # A trap layout: its trap tracks count as tracks.
    ci = BitapAcEngine(_composed(ac, case_dfa, EMBEDDED_KSS), device=CPU, n_streams=8, t_tile=8,
                       layout=plan_bitap_ci(_composed(ac, case_dfa, EMBEDDED_KSS)))
    sci = ci.stage("xx straße kilo ".encode() * 8)
    low = ci.bitap_tables.max_track_bytes - 2
    short = dataclasses.replace(sci, plan=dataclasses.replace(sci.plan, overlap=low))
    with pytest.raises(ValueError, match="longest track"):
        ci.needle_presence_staged(short)
    assert calls == [5]


# -- the plumbing -----------------------------------------------------------------------------


def test_needle_presence_staged_passes_the_plans_overlap(monkeypatch):
    seen = []
    _spy(monkeypatch, bitap_scan, "bitap_presence", 5, seen)
    m = _machine(ac, NEEDLES3)
    eng = BitapAcEngine(m, device=CPU, n_streams=16, t_tile=8)
    hit, miss = eng.stage(b"tshirt and shorts " * 40), eng.stage(b"shirt short " * 40)
    np.testing.assert_array_equal(eng.needle_presence_staged(hit), [True, False, True])
    assert not eng.needle_presence_staged(miss).any()
    assert seen == [hit.plan.overlap, miss.plan.overlap] == [5, 5]
    # A trap layout: the trap mask before the overlap; the trap fires, so the
    # flags decline.
    ci = BitapAcEngine(_composed(ac, case_dfa, EMBEDDED), device=CPU, n_streams=16, t_tile=8,
                       layout=plan_bitap_ci(_composed(ac, case_dfa, EMBEDDED)))
    sci = ci.stage("xx KİLO xx FIX ".encode() * 30)
    args = ci.presence_args(sci)
    assert args[4] is ci.bitap_tables.trapmask and args[5] == sci.plan.overlap
    assert ci.needle_presence_staged(sci) is None
    assert seen[2:] == [sci.plan.overlap] and sci.plan.overlap >= ci.overlap


def test_b7_takes_b4s_design_rule(monkeypatch):
    monkeypatch.setattr(sticky_mod, "sm_count", lambda _dev: 132)
    for S in (32768, 4096, 200):
        wide = torch.zeros(4224, S, dtype=torch.uint8)
        for V in (1, 2, 3):
            btab = torch.zeros(V, 256, dtype=torch.int32)
            d = sticky_mod.bitap_presence_design(wide, btab, 5)
            assert d == sticky_mod.bitap_contains_design(wide, btab, 5)
            assert d.segments == seg.pick_segments(S, 4224, 5, seg.bitap_smem_bytes(V, 0), 132)
            assert sticky_mod.bitap_presence_design(wide, btab).segments == 1
    assert sticky_mod.bitap_presence_design(wide[:20], btab, 19).segments == 1
