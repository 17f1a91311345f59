"""The segmented schedule of B4, the sticky bitap scan ``bitap_contains``
with its trap part, which ``csrc/bitap_count.cu`` runs on the card as the
sticky mode of B2's scan (``csrc/stage.cuh``).

* Exactness: B4's plain version run over every segment of a schedule from
  its scan start, hits and trap planes OR-ed (``or_over_segments`` of
  ``alfred_margaret_tpu_torch/kernels/segments.py``), equals the unsplit
  plain version, and that equals the JAX kernel
  (``_make_bitap_contains_kernel``) in interpret mode on the same staged
  corpus; at k = 1, 2, 3, 7, 16 and 64 with T = 40, not a multiple of 3, 7,
  16 or 64; on bitap layouts of 1, 2 and 3 words and the three IgnoreCase
  layouts of ``test_torch_bitap_ci.py`` (trapless, a trap embedded in the
  match word, a trap register), on stagings with stream 0, fully padded
  streams and streams with no hit; and with the trap tracks of İ, Kelvin K
  and ẞ and a needle written across every cut.
* The guard: ``BitapAcEngine.contains_args`` and the mesh's S3 refuse a
  staging whose overlap is below the longest track (match or trap) less one.
* The plumbing: ``contains_staged`` and the mesh's S3 pass the plan's
  overlap to the wrapper.

Tolerance: exact equality of every hit and trap word.
"""

import dataclasses

import numpy as np
import pytest
import torch

from alfred_margaret_tpu.models import ac as jac
from alfred_margaret_tpu.models import case_dfa as jcase
from alfred_margaret_tpu.ops.bitap_scan import BitapAcEngine as JaxBitapAcEngine
from alfred_margaret_tpu.ops.bitap_scan import plan_bitap as jplan_bitap
from alfred_margaret_tpu.ops.bitap_scan import plan_bitap_ci as jplan_bitap_ci

from alfred_margaret_tpu_torch.kernels import segments as seg
from alfred_margaret_tpu_torch.kernels.bitap_contains import bitap_contains, bitap_contains_plain
from alfred_margaret_tpu_torch.models import ac, case_dfa
from alfred_margaret_tpu_torch.ops import bitap_scan
from alfred_margaret_tpu_torch.ops.bitap_scan import BitapAcEngine, plan_bitap, plan_bitap_ci
from alfred_margaret_tpu_torch.parallel import DistributedAcEngine, make_mesh
from alfred_margaret_tpu_torch.parallel.shard import PLAIN

from test_torch_bitap_ci import _scramble
from test_torch_count_segments import (
    EMBEDDED, KS, KW, NEEDLES3, TRAPLESS, TRAPS, _composed, _machine, _pair, _spy)
from test_torch_segments import _layout_cases
from _torch_count_fixtures import (
    EMBEDDED_KSS, I_DOT, KELVIN, REGISTER, REGISTER_V3, SHARP_S, V2, V3, plant_traps)
from _torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

CPU = torch.device("cpu")
#: Words around the needles: most streams of 40 steps hold no needle.
FILLER = ["lorem", "ipsum", "dolor", "amet", "xyz", "qua"]

#: name: (needles, words, composed, held against the JAX kernel, layout:
#: (match words, embedded trap, trap register))
B4_CASES = {
    "v1": (NEEDLES3, 1, False, True, (1, False, False)),
    "v2": (V2, 2, False, False, (2, False, False)),
    "v3": (V3, 3, False, True, (3, False, False)),
    "trapless": (TRAPLESS, 2, True, False, (1, False, False)),
    "embedded_trap": (EMBEDDED, 2, True, True, (1, True, False)),
    "trap_register": (REGISTER, 2, True, True, (1, False, True)),
}
_B4 = {}


def _sparse_corpus(needles, n, seed):
    """``n`` bytes of filler words with a needle about every tenth word."""
    rng = np.random.default_rng(seed)
    words = []
    while sum(len(w) + 1 for w in words) < n:
        pool = needles if rng.random() < 0.1 else FILLER
        words.append(pool[rng.integers(0, len(pool))])
    return " ".join(words).encode()[:n]


def _b4_case(name):
    """(JAX output or None, the port's staging, the engine, B4's args) of a
    case, built once."""
    if name not in _B4:
        needles, words, composed, jax, _ = B4_CASES[name]
        if composed:
            tm = _composed(ac, case_dfa, needles)
            lay = plan_bitap_ci(tm, max_words=words)
            hay = _scramble(_sparse_corpus(needles, 2000, 3), 3)
            for pos, trap in ((300, TRAPS[0]), (900, TRAPS[1]), (1500, TRAPS[2])):
                hay = hay[:pos] + trap.encode() + hay[pos:]
        else:
            tm = _machine(ac, needles)
            lay = plan_bitap(tm, max_words=words)
            hay = _sparse_corpus(needles, 3000, 11)
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
            np.testing.assert_array_equal(pst.live_np, np.asarray(st.live_np).reshape(-1))
            out = jeng._get_bitap_contains_fn(st.plan.time_len)(jeng._btab_dev, st.streams_dev)
            want = tuple(np.asarray(o).reshape(-1) for o in (out if lay.has_trap else (out,)))
        args = eng.contains_args(pst)
        assert args[-1] == pst.plan.overlap
        _B4[name] = (want, pst, eng, args)
    return _B4[name]


@pytest.mark.parametrize("name", list(B4_CASES))
@pytest.mark.parametrize("k", KS)
def test_b4_segments_equal_unsplit_and_jax(name, k):
    want, pst, eng, args = _b4_case(name)
    lay = eng.bitap
    assert (lay.n_words, any(w.trap_endmask for w in lay.words),
            lay.trap is not None) == B4_CASES[name][4]
    streams, btab, seed, endmask, trapmask, K = args
    T, S = streams.shape
    assert T == 40 and K >= eng.bitap_tables.max_track_bytes - 1
    assert _layout_cases(pst)["stream 0"] and _layout_cases(pst)["padded"]
    whole = _pair(bitap_contains_plain(*args))
    if want is not None:
        for g, w in zip(whole, want):
            np.testing.assert_array_equal(g.numpy(), w)
    got = _pair(seg.or_over_segments(bitap_contains_plain, streams, (btab, seed, endmask),
                                     trapmask, overlap=K, segments=k))
    assert len(got) == len(whole) == 1 + lay.has_trap
    for g, w in zip(got, whole):
        assert g.dtype == torch.int32 and g.shape == (S,) and torch.equal(g, w)
    # Streams with a hit and streams without one.
    assert 0 < int((got[0] != 0).sum()) < int(pst.live_np.sum())
    if lay.has_trap:
        assert got[1].any()  # the traps fired
    # The wrapper on the CPU runs the plain version, whatever the overlap.
    for g, w in zip(_pair(bitap_contains(*args)), whole):
        assert torch.equal(g, w)


@pytest.mark.parametrize("needles,traps,k", [
    (EMBEDDED_KSS, (I_DOT, KELVIN, SHARP_S), 2), (EMBEDDED_KSS, (I_DOT, KELVIN, SHARP_S), 7),
    (REGISTER_V3, (I_DOT, KELVIN), 3), (REGISTER_V3, (I_DOT, KELVIN), 16)])
def test_b4_trap_tracks_across_cuts(needles, traps, k):
    """Trap encodings (in the first half of the streams) and an upper-case
    needle (in the second half) written across each cut p_i: the segment
    that owns p_i reads the whole encoding in its warm-up and own range, so
    the OR of the segments' hits and traps is the unsplit scan's."""
    tm = _composed(ac, case_dfa, needles)
    lay = plan_bitap_ci(tm, max_words=2)
    assert lay.has_trap and (len(lay.all_words()) == 3) == (needles is REGISTER_V3)
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
    hits, trap = bitap_contains_plain(streams, *tables, t.trapmask)
    assert trap[planted].all() and hits[hit].all()
    got = seg.or_over_segments(bitap_contains_plain, streams, tables, t.trapmask, overlap=K,
                               segments=k)
    assert torch.equal(got[0], hits) and torch.equal(got[1], trap)


# -- the guard ------------------------------------------------------------------------------


def test_b4_overlap_below_the_longest_track_raises():
    eng = BitapAcEngine(_machine(ac, NEEDLES3), device=CPU, n_streams=8, t_tile=8)
    hay = b"tshirts and shorts " * 8
    st = eng.stage(hay)
    assert eng.bitap_tables.max_track_bytes == 6 and st.plan.overlap == 5
    short = dataclasses.replace(st, plan=dataclasses.replace(st.plan, overlap=4))
    with pytest.raises(ValueError, match="longest track"):
        eng.contains_args(short)
    with pytest.raises(ValueError, match="longest track"):
        eng.contains_staged(short)
    # At the longest track less one the segments are exact.
    assert eng.contains_staged(st)
    # The mesh's S3 builds its own tables and holds them to the same guard.
    m = _machine(ac, NEEDLES3)
    mesh = DistributedAcEngine(m, make_mesh(["cpu"] * 8, data=4, seq=2), inner="pallas")
    staged = mesh.stage(hay * 25)
    short = dataclasses.replace(staged, plan=dataclasses.replace(staged.plan, overlap=4))
    i, g, dev = next(iter(mesh.shards()))
    with pytest.raises(ValueError, match="longest track"):
        mesh.shard_call("sticky", short, i, g, dev, use_bitap=True)
    assert mesh.contains_any(staged)


# -- the plumbing -----------------------------------------------------------------------------


def test_contains_staged_passes_the_plans_overlap(monkeypatch):
    seen = []
    _spy(monkeypatch, bitap_scan, "bitap_contains", 5, seen)
    m = _machine(ac, NEEDLES3)
    eng = BitapAcEngine(m, device=CPU, n_streams=16, t_tile=8)
    hit, miss = eng.stage(b"tshirts and shorts " * 40), eng.stage(b"shirt short " * 40)
    assert eng.contains_staged(hit) and not eng.contains_staged(miss)
    assert seen == [hit.plan.overlap, miss.plan.overlap] == [5, 5]
    # A trap layout: the trap mask before the overlap.
    ci = BitapAcEngine(_composed(ac, case_dfa, EMBEDDED), device=CPU, n_streams=16, t_tile=8,
                       layout=plan_bitap_ci(_composed(ac, case_dfa, EMBEDDED)))
    sci = ci.stage("xx KİLO xx FIX ".encode() * 30)
    args = ci.contains_args(sci)
    assert args[4] is ci.bitap_tables.trapmask and args[5] == sci.plan.overlap
    assert ci.contains_staged(sci)
    assert seen[2:] == [sci.plan.overlap] and sci.plan.overlap >= ci.overlap


def test_mesh_sticky_bitap_site_passes_the_plans_overlap():
    m = _machine(ac, NEEDLES3)
    eng = DistributedAcEngine(m, make_mesh(["cpu"] * 8, data=4, seq=2), inner="pallas")
    assert eng.sticky_route() == "bitap"
    hay = b"tshirts and shorts " * 200
    staged = eng.stage(hay)
    for i, g, dev in eng.shards():
        fn, args, kw = eng.shard_call("sticky", staged, i, g, dev)
        assert fn.__name__ == "bitap_contains"
        assert kw == {"overlap": staged.plan.overlap} and args[4] is None
        assert torch.equal(fn(*args, **kw), PLAIN[fn](*args, **kw))
    assert eng.contains_any(staged)
    assert not eng.contains_any(eng.stage(b"shirt short " * 400))
