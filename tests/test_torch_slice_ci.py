"""The PyTorch port's Searcher under IgnoreCase, end to end on the CPU.

``Searcher.build(IGNORE_CASE, ...)`` on ``device="cpu"`` against the JAX
package's ``Searcher(IGNORE_CASE, engine="cpp")`` on the same seeded
haystacks: ``count_matches``, ``contains_any``, ``contains_all`` and
``all_matches_arrays``, one-shot and staged, on both IgnoreCase routes:

* the composed case DFA (forced with ``AUTO_COMPOSE_BYTES`` = 0, as
  ``tests/test_case_dfa.py`` forces it; ``stage`` composes anyway), on the
  byte-class bitap engine with and without trap tracks, on a trap-bearing
  haystack, and on the dense engine;
* the lowering path: one-shot haystacks under ``AUTO_COMPOSE_BYTES``, a
  needle set that is not whole code points, and every backend.

Also ``set_case_sensitivity`` and the reference's case probes (İ, Ⱥ, Kelvin
K, Å, ẞ/ß, invalid UTF-8).  Tolerance: exact equality of every count, flag
and match list (ends in raw coordinates).
"""

import numpy as np
import pytest

import alfred_margaret_tpu as jamt

from alfred_margaret_tpu_torch import CASE_SENSITIVE, IGNORE_CASE, Searcher
from alfred_margaret_tpu_torch import engine as tengine
from alfred_margaret_tpu_torch.bench.dataformat import synth_corpus
from alfred_margaret_tpu_torch.models import ac
from alfred_margaret_tpu_torch.ops.bitap_scan import BitapAcEngine
from alfred_margaret_tpu_torch.ops.pallas_scan import DenseAcEngine
from _torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

NEEDLES3 = ["tshirt", "shirts", "shorts"]
TRAPPY = ["kilo", "fix", "straße", "å"]
PROBES = "KİLO Ⱥⱥ KILO Ångström STRAẞE straße FİX fix ǅ 日本 ".encode()
INVALID = b"\xff\xfe invalid \x80 utf-8 caf\xc3\xa9 \xc3"


def _scramble(text: bytes, seed: int) -> bytes:
    """ASCII letters uppercased at random, from a seeded generator."""
    a = np.frombuffer(text, np.uint8).copy()
    up = (a >= 97) & (a <= 122) & (np.random.default_rng(seed).random(len(a)) < 0.5)
    a[up] -= 32
    return a.tobytes()


def _hay(needles, size, seed, extra=b""):
    return _scramble(synth_corpus(needles, size, hit_fraction=0.05, seed=seed), seed) + extra


def _answers(s, h):
    ends, vids = s.all_matches_arrays(h)
    return s.count_matches(h), s.contains_any(h), s.contains_all(h), ends.tolist(), vids.tolist()


def _check(s, hay, staged=True):
    j = jamt.Searcher.build_with_values(
        jamt.IGNORE_CASE, [(n, v) for n, v in s.needles], engine="cpp")
    want = _answers(j, hay)
    assert _answers(s, hay) == want
    if staged:
        st = s.stage(hay)
        assert _answers(s, st) == want
        return want, st
    return want, None


#: (name, needles, corpus bytes, engine, trap tracks): the bench needles
#: carry the İ trap embedded in their word ('i'), TRAPPY a trap register.
CASES = [
    ("bench_bitap", NEEDLES3, 1 << 13, BitapAcEngine, True),
    ("trapless_bitap", ["dress", "shoe", "glove"], 1 << 13, BitapAcEngine, False),
    ("trap_bitap", TRAPPY, 1 << 13, BitapAcEngine, True),
    ("dense", [f"{a}{b}x" for a in "abcdefg" for b in "hij"] + ["kilo"], 1 << 13, DenseAcEngine,
     None),
]


@pytest.mark.parametrize("name,needles,size,kind,trap", CASES, ids=[c[0] for c in CASES])
def test_composed_route_matches_jax(monkeypatch, name, needles, size, kind, trap):
    monkeypatch.setattr(tengine.MatchEngine, "AUTO_COMPOSE_BYTES", 0)
    s = Searcher.build(IGNORE_CASE, needles, device="cpu")
    hay = _hay(needles, size, 3, extra=PROBES + INVALID)
    want, st = _check(s, hay)
    assert want[0] > 0 and want[1]
    ci = s._engine._ci
    assert ci is not None and ci.machine.composed_ci and st.composed and st.lowered is None
    eng = ci.device_engine()
    assert type(eng) is kind
    if kind is BitapAcEngine:
        assert eng.bitap.ci and eng.bitap.has_trap == trap
    # The composed machine scans raw bytes: no lowering at all.
    assert st.data.tobytes() == hay


def test_composed_route_on_trapped_streams(monkeypatch):
    """Trap-bearing haystacks (İ, Kelvin K, Å, ẞ in some streams): the counts,
    flags and matches of the JAX engine, through the trap recovery."""
    monkeypatch.setattr(tengine.MatchEngine, "AUTO_COMPOSE_BYTES", 0)
    s = Searcher.build(IGNORE_CASE, TRAPPY, device="cpu")
    hay = _hay(TRAPPY, 1 << 14, 5)
    hay = hay[:3000] + "KİLO".encode() + hay[3000:9000] + "KKILO FİX".encode() + hay[9000:]
    want, st = _check(s, hay)
    eng = s._engine._ci.device_engine()
    _, trap = eng.stream_counts(st.device)
    assert trap.any()
    assert eng.needle_presence_staged(st.device) is None  # contains_all took extraction
    assert want[0] == ac.count_matches(s.automaton, hay, IGNORE_CASE)


def test_lowering_route_matches_jax():
    """One-shot haystacks below ``AUTO_COMPOSE_BYTES`` are lowered on the host
    and scanned by the CaseSensitive machine; ends map back to raw."""
    s = Searcher.build(IGNORE_CASE, TRAPPY + ["ⱥb"], device="cpu")
    hay = _hay(TRAPPY, 1 << 13, 9, extra=PROBES + "ȺB".encode())
    _check(s, hay, staged=False)
    assert s._engine._ci is False  # never composed
    ms = s._engine.matches(hay, IGNORE_CASE)
    assert ms.lowered is not None and not ms.lowered.identity


def test_ineligible_needles_take_the_lowering_route():
    """A needle that is not whole code points: no composed DFA, even staged."""
    s = Searcher.build(IGNORE_CASE, ["kilo", b"ab\xc3", "fix"], device="cpu")
    hay = _hay(["kilo", "fix"], 1 << 13, 11, extra=b"AB\xc3 ab\xc3\xa9 " + PROBES + INVALID)
    want, st = _check(s, hay)
    assert s._engine._ci is None and not st.composed and st.lowered is not None
    assert st.device is not None and want[0] > 0


@pytest.mark.parametrize("engine", ["python", "cpp", "xla"])
def test_host_backends_match_jax(monkeypatch, engine):
    monkeypatch.setattr(tengine.MatchEngine, "AUTO_COMPOSE_BYTES", 0)
    s = Searcher.build(IGNORE_CASE, TRAPPY, engine=engine, device="cpu")
    hay = _hay(TRAPPY, 1 << 11, 13, extra=PROBES + INVALID)
    _check(s, hay)
    monkeypatch.setattr(tengine.MatchEngine, "AUTO_COMPOSE_BYTES", 1 << 40)
    _check(Searcher.build(IGNORE_CASE, TRAPPY, engine=engine, device="cpu"), hay, staged=False)


def test_probes_and_set_case_sensitivity():
    cs = Searcher.build(CASE_SENSITIVE, ["kilo", "i", "straße", "å", ""], device="cpu")
    ic = cs.set_case_sensitivity(IGNORE_CASE)
    assert ic.case_sensitivity is IGNORE_CASE and ic.automaton is cs.automaton
    assert ic.needles == cs.needles and ic.device == cs.device and ic != cs
    assert ic.set_case_sensitivity(CASE_SENSITIVE) == cs
    j = jamt.Searcher.build(jamt.CASE_SENSITIVE, ["kilo", "i", "straße", "å", ""], engine="cpp")
    jic = j.set_case_sensitivity(jamt.IGNORE_CASE)
    for hay in (PROBES, INVALID, PROBES * 40, b""):
        assert _answers(ic, hay) == _answers(jic, hay)
        assert _answers(cs, hay) == _answers(j, hay)
    # Raw ends, as the scalar oracle reports them.
    ends, vids = ic.all_matches_arrays(PROBES)
    oracle = ac.all_matches(ic.automaton, PROBES, IGNORE_CASE)
    assert ends.tolist() == [m.pos for m in oracle] and len(vids) == len(oracle) > 0
