"""The rest of the port's ``Searcher`` against the JAX package's, and the
port's API surface.

Mirrors the tests of ``tests/test_searcher.py`` that reach
``build_needle_id_searcher``, ``map_searcher``, ``+``, ``from_json`` and
``adopt_staged``, and ``tests/test_api_surface.py``: each runs the port's
``Searcher`` on ``device="cpu"`` (the kernels' plain versions) beside the
JAX ``Searcher`` on the same inputs.  ``adopt_staged`` moves one staging of
the bench needles into each device engine (dense, bitap, comb16, comb32,
grouped, composed IgnoreCase) and holds the adopted answers against a
fresh staging, the port's host C++ engine and the JAX ``Searcher``'s
``adopt_staged`` (``engine="cpp"``).  Tolerance: exact equality.
"""

import json

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import alfred_margaret_tpu as jamt

import alfred_margaret_tpu_torch as port
from alfred_margaret_tpu_torch import CASE_SENSITIVE, IGNORE_CASE, Searcher
from alfred_margaret_tpu_torch import engine as tengine
from alfred_margaret_tpu_torch.bench.dataformat import synth_corpus
from alfred_margaret_tpu_torch.ops.bitap_scan import BitapAcEngine
from alfred_margaret_tpu_torch.ops.comb16_scan import Comb16AcEngine
from alfred_margaret_tpu_torch.ops.comb_scan import CombAcEngine, make_engine
from alfred_margaret_tpu_torch.ops.grouped import GroupedAcEngine
from alfred_margaret_tpu_torch.ops.pallas_scan import DenseAcEngine
from alfred_margaret_tpu_torch.utils import utf8

from test_torch_comb16 import CONFIG2
from test_torch_grouped import MID, config5_needles
from _torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

CPU = "cpu"
NEEDLES3 = ["tshirt", "shirts", "shorts"]
DENSE30 = [f"{a}{b}x" for a in "abcdefg" for b in "hij"] + ["kilo", "xyzzy"]


def _j(s):
    """The JAX ``Searcher`` with this port searcher's needles, values and case."""
    return jamt.Searcher.build_with_values(jamt.CaseSensitivity(s.case_sensitivity.value),
                                           s.needles, engine="cpp")


# -- build_needle_id_searcher and contains_all (test_searcher.py) -------------------


def test_needle_id_searcher_matches_jax():
    for case, jcase in ((CASE_SENSITIVE, jamt.CASE_SENSITIVE), (IGNORE_CASE, jamt.IGNORE_CASE)):
        got = Searcher.build_needle_id_searcher(case, NEEDLES3 + ["", "café"], device=CPU)
        want = jamt.Searcher.build_needle_id_searcher(jcase, NEEDLES3 + ["", "café"])
        assert got.needles == want.needles and got.to_json() == want.to_json()
        assert got.automaton.values == want.automaton.values == [0, 1, 2, 3, 4]
    empty = Searcher.build_needle_id_searcher(CASE_SENSITIVE, [""], device=CPU)
    assert not any(empty.contains_all(h) for h in ["", "a", "hello world"])
    assert Searcher.build_needle_id_searcher(CASE_SENSITIVE, [], device=CPU).contains_all("x")


@given(st.lists(st.text(min_size=1, max_size=4), max_size=4), st.text(max_size=50),
       st.sampled_from(["cs", "ci"]))
@settings(max_examples=100, deadline=None)
def test_contains_all_equivalent_to_is_infix_of(needles, haystack, mode):
    if mode == "ci":
        needles = [utf8.lower_str(n) for n in needles]
        case, jcase, hay = IGNORE_CASE, jamt.IGNORE_CASE, utf8.lower_str(haystack)
    else:
        case, jcase, hay = CASE_SENSITIVE, jamt.CASE_SENSITIVE, haystack
    got = Searcher.build_needle_id_searcher(case, needles, device=CPU).contains_all(haystack)
    assert got is jamt.Searcher.build_needle_id_searcher(jcase, needles).contains_all(haystack)
    assert got is all(n in hay for n in needles)


# -- structure: map_searcher, +, from_json -------------------------------------------


def test_json_roundtrip_across_packages():
    for case in (IGNORE_CASE, CASE_SENSITIVE):
        a = Searcher.build_with_values(case, [("foo", 1), ("bär", [2, "x"]), ("", None)],
                                       device=CPU)
        b = Searcher.from_json(a.to_json(), device=CPU)
        assert a == b and hash(a) == hash(b) and b.needles == a.needles
        j = jamt.Searcher.from_json(a.to_json())
        assert j.to_json() == a.to_json()
        c = Searcher.from_json(j.to_json(), engine="cpp", device=CPU)
        assert c == a and c._engine.engine == "cpp"
    assert Searcher.from_json(Searcher.build(IGNORE_CASE, ["foo", "bär"], device=CPU).to_json(),
                              device=CPU).contains_any("BÄR") is True


def test_semigroup_concat():
    a = Searcher.build(CASE_SENSITIVE, ["foo"], device=CPU)
    b = Searcher.build(CASE_SENSITIVE, ["bar"], device=CPU)
    c = a + b
    assert c.contains_any("xbarx") and c.contains_any("xfoox")
    assert c.needles == (jamt.Searcher.build(jamt.CASE_SENSITIVE, ["foo"])
                         + jamt.Searcher.build(jamt.CASE_SENSITIVE, ["bar"])).needles
    assert str(c.device) == CPU and c._engine_name == "auto"
    with pytest.raises(ValueError, match="different case sensitivity"):
        a + Searcher.build(IGNORE_CASE, ["baz"], device=CPU)


def test_map_searcher():
    a = Searcher.build_needle_id_searcher(CASE_SENSITIVE, ["x", "y"], device=CPU)
    doubled = a.map_searcher(lambda v: v * 10)
    assert [m.value for m in doubled.all_matches("xy")] == [0, 10]
    want = jamt.Searcher.build_needle_id_searcher(jamt.CASE_SENSITIVE, ["x", "y"]).map_searcher(
        lambda v: v * 10)
    assert doubled.needles == want.needles and doubled.automaton.values == want.automaton.values
    assert doubled.automaton.delta is a.automaton.delta  # the tables are shared
    assert a.automaton.values == [0, 1] and str(doubled.device) == CPU
    m = a.automaton.map_values(str)
    assert m.values == ["0", "1"] and m.needles is a.automaton.needles


def test_set_case_sensitivity():
    a = Searcher.build(CASE_SENSITIVE, ["foo"], device=CPU)
    assert a.contains_any("FOO") is False
    assert a.set_case_sensitivity(IGNORE_CASE).contains_any("FOO") is True


def test_nothing_raises_not_implemented():
    s = Searcher.build(CASE_SENSITIVE, ["ab"], device=CPU)
    for name in ("build_needle_id_searcher", "map_searcher", "__add__", "from_json",
                 "adopt_staged"):
        assert callable(getattr(s, name))
    import inspect

    import alfred_margaret_tpu_torch.searcher as tsearcher

    assert "NotImplementedError" not in inspect.getsource(tsearcher)


# -- adopt_staged (test_searcher.py::TestAdoptStaged) --------------------------------


def _answers(s, h):
    ends, vids = s.all_matches_arrays(h)
    return s.count_matches(h), s.contains_any(h), s.contains_all(h), ends.tolist(), vids.tolist()


def test_adopt_reuses_device_streams():
    s1 = Searcher.build_needle_id_searcher(CASE_SENSITIVE, ["foofoofoo", "barbarbar"], device=CPU)
    s2 = Searcher.build_needle_id_searcher(CASE_SENSITIVE, ["oof", "rba"], device=CPU)
    hay = "foofoofoo x rba y " * 3000
    st1 = s1.stage(hay)
    st2 = s2.adopt_staged(st1)
    assert st2.device is st1.device and st2.owner is s2.automaton
    assert _answers(s2, st2) == _answers(s2, hay) == _answers(_j(s2), hay)
    with pytest.raises(ValueError, match="different searcher"):
        s1.count_matches(st2)


def test_adopt_restages_when_overlap_insufficient():
    s1 = Searcher.build(CASE_SENSITIVE, ["ab"], device=CPU)
    s2 = Searcher.build(CASE_SENSITIVE, ["abcdefghij" * 3], device=CPU)
    hay = ("ab" + "abcdefghij" * 3 + "x") * 1500
    st1 = s1.stage(hay)
    st2 = s2.adopt_staged(st1)
    assert st2.device is not st1.device and st2.device.plan.overlap == 29
    assert s2.count_matches(st2) == s2.count_matches(hay) == 1500


def test_adopt_ignore_case_reuses_lowering(monkeypatch):
    monkeypatch.setattr(tengine, "COMPOSED_CI_MAX_STATES", 0)  # the lowering path
    s1 = Searcher.build_needle_id_searcher(IGNORE_CASE, ["straße"], device=CPU)
    s2 = Searcher.build_needle_id_searcher(IGNORE_CASE, ["ab"], device=CPU)
    hay = "STRAßE ab AB xyz " * 2000
    st1 = s1.stage(hay)
    st2 = s2.adopt_staged(st1)
    assert st2.lowered is st1.lowered and st2.device is st1.device
    assert _answers(s2, st2) == _answers(s2, hay) == _answers(_j(s2), hay)


def test_adopt_lowered_into_case_sensitive_raises(monkeypatch):
    monkeypatch.setattr(tengine, "COMPOSED_CI_MAX_STATES", 0)
    st = Searcher.build(IGNORE_CASE, ["ab"], device=CPU).stage("ABab" * 2000)
    with pytest.raises(ValueError, match="raw bytes are not retained"):
        Searcher.build(CASE_SENSITIVE, ["AB"], device=CPU).adopt_staged(st)


def test_adopt_lowered_into_composed_raises(monkeypatch):
    monkeypatch.setattr(tengine, "COMPOSED_CI_MAX_STATES", 0)
    st = Searcher.build(IGNORE_CASE, ["ab"], device=CPU).stage("ABab" * 2000)
    monkeypatch.setattr(tengine, "COMPOSED_CI_MAX_STATES", 4096)
    with pytest.raises(ValueError, match="raw bytes are not retained"):
        Searcher.build(IGNORE_CASE, ["tshirt"], device=CPU).adopt_staged(st)


def test_adopt_raw_into_composed_ci(monkeypatch):
    monkeypatch.setattr(tengine.MatchEngine, "AUTO_COMPOSE_BYTES", 0)
    s_cs = Searcher.build_needle_id_searcher(CASE_SENSITIVE, ["tshirt"], device=CPU)
    s_ci = Searcher.build_needle_id_searcher(IGNORE_CASE, ["tshirt", "k"], device=CPU)
    hay = "TSHIRT tshirt K K x " * 2000
    st_ci = s_ci.adopt_staged(s_cs.stage(hay))
    assert st_ci.composed and st_ci.case is IGNORE_CASE and st_ci.lowered is None
    assert _answers(s_ci, st_ci) == _answers(s_ci, hay) == _answers(_j(s_ci), hay)


def test_adopt_raw_into_lowering_engine_lowers():
    s_cs = Searcher.build(CASE_SENSITIVE, ["tshirt"], device=CPU)
    s_ci = Searcher.build_needle_id_searcher(IGNORE_CASE, ["ab"], device=CPU)
    s_ci._engine._ci = None  # composition unavailable: the lowering path
    hay = "ABab TSHIRT " * 1000
    st = s_ci.adopt_staged(s_cs.stage(hay))
    assert st.lowered is not None and not st.composed and st.case is IGNORE_CASE
    assert _answers(s_ci, st) == _answers(_j(s_ci), hay)


def test_adopt_host_and_reference_engines_keep_bytes():
    hay = synth_corpus(NEEDLES3, 1 << 13, hit_fraction=0.05, seed=4)
    st = Searcher.build(CASE_SENSITIVE, NEEDLES3, device=CPU).stage(hay)
    for engine in ("cpp", "xla", "python"):
        s = Searcher.build_needle_id_searcher(CASE_SENSITIVE, DENSE30 + NEEDLES3, engine=engine,
                                              device=CPU)
        got = s.adopt_staged(st)
        assert got.device is None and got.data is st.data
        assert _answers(s, got) == _answers(_j(s), hay)
    # A staging that keeps only its bytes is staged anew by a device engine.
    s_x = Searcher.build(CASE_SENSITIVE, NEEDLES3, engine="xla", device=CPU)
    st_x = s_x.stage(hay)
    assert st_x.device is None
    s = Searcher.build_needle_id_searcher(CASE_SENSITIVE, NEEDLES3, device=CPU)
    got = s.adopt_staged(st_x)
    assert got.device is not None and _answers(s, got) == _answers(_j(s), hay)


#: Streams of the engines below: fewer than the default 32768 keep the
#: plain versions quick; every engine of one test has the same count.
S = 2048


def _with_engine(s, grouped=False):
    """``s`` with its device engine built as ``MatchEngine`` builds it, at
    ``S`` streams (grouped: at most five table rows a group)."""
    m = s.automaton
    s._engine._device_eng = (GroupedAcEngine(m, device=CPU, max_rows=5, n_streams=S) if grouped
                             else make_engine(m, CPU, n_streams=S))
    return s


#: (name, needles, engine type, reuses the staging of the bench needles:
#: overlap 5 covers needles of up to 6 bytes).
TIERS = [
    ("bitap", ["shirt", "short", "tees"], BitapAcEngine, True),
    ("dense", DENSE30, DenseAcEngine, True),
    ("comb16", CONFIG2, Comb16AcEngine, False),
    ("comb32", config5_needles(300), CombAcEngine, False),
    ("grouped", MID, GroupedAcEngine, None),
]


@pytest.mark.parametrize("name,needles,kind,reuse", TIERS, ids=[t[0] for t in TIERS])
def test_adopt_into_each_device_engine(name, needles, kind, reuse):
    words = sorted({w for w in needles if w}, key=len)[:40]
    hay = synth_corpus(NEEDLES3 + words, 1 << 14, hit_fraction=0.05, seed=11)
    st0 = _with_engine(Searcher.build(CASE_SENSITIVE, NEEDLES3, device=CPU)).stage(hay)
    s = _with_engine(Searcher.build_needle_id_searcher(CASE_SENSITIVE, needles, device=CPU),
                     grouped=name == "grouped")
    eng = s._engine.device_engine()
    assert type(eng) is kind
    st = s.adopt_staged(st0)
    need = max(0, s.automaton.max_needle_bytes - 1)
    if reuse is None:
        reuse = need <= st0.device.plan.overlap
    assert (st.device is st0.device) is reuse
    assert st.device.plan.overlap >= need
    want = _answers(s, s.stage(hay))
    assert _answers(s, st) == want
    j = _j(s)
    jst = j.adopt_staged(jamt.Searcher.build(jamt.CASE_SENSITIVE, NEEDLES3, engine="cpp")
                         .stage(hay))
    assert _answers(j, jst) == want == _answers(
        Searcher.build_needle_id_searcher(CASE_SENSITIVE, needles, engine="cpp", device=CPU), hay)
    assert want[0] > 0


def test_adopt_into_composed_ignore_case_restages():
    """The bench needles' composed machine needs a longer warm-up (10 bytes)
    than their CaseSensitive staging carries (5): adoption restages."""
    hay = synth_corpus(NEEDLES3, 1 << 14, hit_fraction=0.05, seed=12).upper()
    st0 = Searcher.build(CASE_SENSITIVE, NEEDLES3, device=CPU).stage(hay)
    s = Searcher.build_needle_id_searcher(IGNORE_CASE, NEEDLES3, device=CPU)
    st = s.adopt_staged(st0)
    assert st.composed and st.device is not st0.device
    assert (st0.device.plan.overlap, st.device.plan.overlap) == (5, 10)
    assert isinstance(s._engine._ci.device_engine(), BitapAcEngine)
    want = _answers(s, s.stage(hay))
    assert _answers(s, st) == want == _answers(_j(s), hay)
    # A composed staging feeds another composed searcher whose overlap it covers.
    s2 = Searcher.build_needle_id_searcher(IGNORE_CASE, ["shirt", "k"], device=CPU)
    st2 = s2.adopt_staged(st)
    assert st2.composed and st2.device is st.device
    assert _answers(s2, st2) == _answers(_j(s2), hay)


# -- API surface (test_api_surface.py) ------------------------------------------------


def test_utf8_surface():
    for name in ["length_utf8", "lower_str", "lower_code_point", "to_lower_ascii",
                 "unlower_code_point", "print_unlowerings", "is_case_invariant", "unicode2utf8",
                 "decode_code_point", "unsafe_index_code_point", "decode_utf8",
                 "skip_code_points_backwards", "unsafe_cut_utf8", "unsafe_slice_utf8",
                 "lower_transform", "decode_utf8_np", "raw_match_starts"]:
        assert callable(getattr(utf8, name)), name
    assert utf8.length_utf8("𐍈") == 4


def test_ac_and_case_dfa_surface():
    from alfred_margaret_tpu_torch.models import ac, case_dfa

    for name in ["build", "run_text", "run_lower", "run_with_case", "needle_casings", "Match",
                 "Done", "Step", "AcMachine", "count_matches", "all_matches", "save_npz",
                 "load_npz"]:
        assert hasattr(ac, name), name
    assert set(ac.needle_casings("k")) >= {"k", "K"}
    for name in ["compose_build", "eligible", "max_raw_match_bytes"]:
        assert callable(getattr(case_dfa, name)), name


def test_searcher_replacer_splitter_surface():
    s = Searcher.build(CASE_SENSITIVE, ["ab"], device=CPU)
    for name in ["build", "build_with_values", "build_needle_id_searcher", "contains_any",
                 "contains_all", "count_matches", "all_matches", "needles", "num_needles",
                 "case_sensitivity", "automaton", "map_searcher", "set_case_sensitivity",
                 "to_json", "from_json", "stage", "adopt_staged", "distributed"]:
        assert hasattr(s, name), name
    assert (s + Searcher.build(CASE_SENSITIVE, ["cd"], device=CPU)).num_needles == 2
    from alfred_margaret_tpu_torch.replacer import MAX_BOUND, Payload

    r = port.Replacer.build(CASE_SENSITIVE, [("a", "b")], device=CPU)
    for name in ["run", "run_with_limit", "compose", "map_replacement", "set_case_sensitivity",
                 "case_sensitivity", "to_json", "from_json", "save_npz", "load_npz"]:
        assert hasattr(r, name), name
    assert Payload(0, 1, 1, b"x").needle_replacement == b"x" and MAX_BOUND == 2**63 - 1
    assert port.Payload is Payload
    sp = port.Splitter.build(",", device=CPU)
    for name in ["split", "split_ignore_case", "split_reverse", "split_reverse_ignore_case",
                 "separator", "automaton", "to_json", "from_json"]:
        assert hasattr(sp, name), name
    assert set(jamt.__all__) <= set(port.__all__)


def test_boyer_moore_surfaces():
    from alfred_margaret_tpu_torch.boyer_moore import automaton as bma
    from alfred_margaret_tpu_torch.boyer_moore import replacer as bmr
    from alfred_margaret_tpu_torch.boyer_moore import searcher as bms
    from alfred_margaret_tpu_torch.boyer_moore_ci import automaton as bmca
    from alfred_margaret_tpu_torch.boyer_moore_ci import replacer as bmcr
    from alfred_margaret_tpu_torch.boyer_moore_ci import searcher as bmcs

    a = bma.build_automaton("needle")
    assert bma.pattern_length(a) == 6 and bma.pattern_text(a) == b"needle"
    assert callable(bma.run_text) and callable(bmr.replace_single_limited)
    assert bms.Searcher.build(["a", "b"], device=CPU).contains_any(b"xa")
    bmca.build_automaton("straße")
    assert callable(bmca.run_text) and callable(bmcr.replace_single_limited)
    assert bmca.minimum_skip_for_code_point(ord("k")) >= 1
    assert bmcs.Searcher.build(["k"], device=CPU).contains_any("KELVIN")


def test_parallel_and_case_surface():
    from alfred_margaret_tpu_torch.parallel import DistributedAcEngine, init_distributed, make_mesh
    from alfred_margaret_tpu_torch.utils.case import CaseSensitivity

    assert callable(DistributedAcEngine) and callable(init_distributed) and callable(make_mesh)
    for c in (CASE_SENSITIVE, IGNORE_CASE):
        assert CaseSensitivity.from_json(c.to_json()) is c
    assert json.loads(Searcher.build(IGNORE_CASE, ["a"], device=CPU).to_json())[
        "caseSensitivity"] == jamt.IGNORE_CASE.to_json()
