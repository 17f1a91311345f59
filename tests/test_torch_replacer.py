"""The port's ``Replacer`` against the JAX package's.

Mirrors ``tests/test_replacer.py`` and ``tests/test_replacer_incremental.py``
on ``device="cpu"``: every output of the port's ``Replacer`` is held byte
for byte against the JAX ``Replacer`` (``engine="cpp"``, and
``engine="python"`` where the JAX test uses the scalar engine) on the same
inputs, hypothesis-drawn or seeded, and against the reference's answer
where the JAX test states one.  Every pass path is covered: the batched
single splice, the incremental loop (its window rescans and its full
rescan when the windows cover half the text), the full-rescan loop (the
lowering path, and ``INCREMENTAL`` off as ``AMT_NO_INCREMENTAL=1`` sets
it), ``run_with_limit`` and staged handles, on the host backends and on
the device backend (haystacks of 4 KiB and more: the kernels' plain
versions), with the host C++ helpers and without them (``AMT_NO_NATIVE``:
the numpy splices and overlap removal, the Python window scan).  The
artifact (``save_npz`` / ``load_npz``, ``Payload`` values under the
``__payload__`` tag) and the JSON form cross between the packages both
ways.  Tolerance: exact equality.
"""

import random

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import alfred_margaret_tpu as jamt

from alfred_margaret_tpu_torch import CASE_SENSITIVE, IGNORE_CASE, Payload, Replacer
from alfred_margaret_tpu_torch import engine as tengine
from alfred_margaret_tpu_torch import replacer as trep
from alfred_margaret_tpu_torch.bench.dataformat import synth_corpus
from alfred_margaret_tpu_torch.models import ac
from alfred_margaret_tpu_torch.utils import utf8

from test_torch_comb16 import CONFIG2
from _torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

CPU = "cpu"
CONFIG4 = [("tshirt", "TEE"), ("shirts", "SHIRT"), ("shorts", "S"), ("ee", "f")]
CASCADE = [("tshirt", "shirts"), ("shirts", "shorts"), ("shorts", "x")]


def _jcase(case):
    return jamt.CaseSensitivity(case.value)


def _pairs(r):
    """(needle, payload fields) of a replacer of either package."""
    return [(n, p._astuple()) for n, p in r.searcher.needles]


def _run(case, replaces, haystack, engine="auto"):
    """The port's output, held against the JAX ``Replacer`` (host C++)."""
    got = Replacer.build(case, replaces, engine=engine, device=CPU).run(haystack)
    want = jamt.Replacer.build(_jcase(case), replaces, engine="cpp").run(haystack)
    assert got == want, (replaces, haystack[:80])
    return got


@pytest.fixture(params=["native", "no_native"])
def native(request, monkeypatch):
    """Each test once with the host C++ helpers and once without them."""
    if request.param == "no_native":
        monkeypatch.setenv("AMT_NO_NATIVE", "1")
        monkeypatch.setattr(utf8, "_NATIVE_LIB", None)
        monkeypatch.setattr(utf8, "_NATIVE_TRIED", True)
        monkeypatch.setattr(trep.Replacer, "_window_cpp", None, raising=False)
    return request.param


# -- test_replacer.py ------------------------------------------------------------------


def test_readme(native):
    r = Replacer.build(CASE_SENSITIVE, [("tshirt", "banana"), ("shirt", "pear")], device=CPU)
    assert r.run("tshirts for sale") == "bananas for sale"
    assert r.run("tshirts and shirts for sale") == "bananas and pears for sale"
    assert r.run("sweatshirts and shirtshirts") == "sweabananas and shirbananas"
    assert r.run("sweatshirts and shirttshirts") == "sweabananas and pearbananas"


def test_run_replaces_all_and_priorities(native):
    assert _run(CASE_SENSITIVE, [("A", "B")], "AXAXB") == "BXBXB"
    assert _run(CASE_SENSITIVE, [("A", "B"), ("X", "Y")], "AXAXB") == "BYBYB"
    assert _run(CASE_SENSITIVE, [("aaa", ""), ("b", "c")], "aaabaaa") == "c"
    assert _run(CASE_SENSITIVE, [("A", "B"), ("Q", "r"), ("Z", "")], "AXAXB") == "BXBXB"
    assert _run(CASE_SENSITIVE, [("aa", "zz"), ("bb", "w")], "aaabbb") == "zzawb"
    assert _run(CASE_SENSITIVE, [("aaa", "")], "aaaaa") == "aa"
    assert _run(CASE_SENSITIVE, [("A", ""), ("BBBB", "bingo")], "BBABB") == "bingo"
    assert _run(CASE_SENSITIVE, [("BB", ""), ("BBBB", "bingo")], "BBBB") == ""
    assert (_run(CASE_SENSITIVE, [("\U0001f574", "levitating man")], "the \U0001f574")
            == "the levitating man")


def test_run_ignore_case(native):
    for pairs, hay, want in [
        ([("A", "B")], "AXAXB", "BXBXB"), ([("A", "B")], "axaxb", "BxBxb"),
        ([("a", "b")], "AXAXB", "bXbXB"), ([("A", "B"), ("X", "Y")], "axaxb", "BYBYb"),
        ([("a", "b"), ("x", "y")], "AXAXB", "bybyB"), ([("foo", "BAR"), ("bar", "BAZ")], "Foo", "BAZ"),
        ([("éclair", "lightning")], "Éclair", "lightning"), ([("å", "b")], "åÅÅ", "bbb"),
        ([("k", "m")], "KkK", "mmm"), ([("ǳ", "z")], "ǳǲǱ", "zzz"),
        ([("bèta", "α"), ("Α", "alpha")], "BÈTA", "alpha"), ([("ßèta", "sseta")], "ẞÈTA", "sseta"),
        ([("\U0001f574", "man")], "the \U0001f574", "the man"),
    ]:
        assert _run(IGNORE_CASE, pairs, hay) == want


def test_run_with_limit(native):
    for flag in (True, False):
        r = Replacer.build(CASE_SENSITIVE, [("a", "xxxx")], device=CPU)
        j = jamt.Replacer.build(jamt.CASE_SENSITIVE, [("a", "xxxx")], engine="cpp")
        assert r.run_with_limit("aa", 8) == j.run_with_limit("aa", 8) == "xxxxxxxx"
        assert r.run_with_limit("aa", 7) is j.run_with_limit("aa", 7) is None


HAYSTACK_CHARS = st.one_of(st.sampled_from("abAB"), st.just("İ"), st.characters(codec="utf-8"))
genHaystack = st.builds("".join, st.lists(HAYSTACK_CHARS, max_size=10))
genReplaces = st.lists(st.tuples(st.text(alphabet="abAB", min_size=1, max_size=3),
                                 st.text(max_size=5)), max_size=4)


@given(genHaystack, st.sampled_from(["cs", "ci"]), genReplaces, genReplaces)
@settings(max_examples=60, deadline=None)
def test_compose(haystack, mode, replaces1, replaces2):
    case = IGNORE_CASE if mode == "ci" else CASE_SENSITIVE
    if case is IGNORE_CASE:
        replaces1 = [(utf8.lower_str(n), r) for n, r in replaces1]
        replaces2 = [(utf8.lower_str(n), r) for n, r in replaces2]
    rm1 = Replacer.build(case, replaces1, device=CPU)
    rm2 = Replacer.build(case, replaces2, device=CPU)
    rm12 = rm1.compose(rm2)
    assert str(rm12.searcher.device) == CPU
    got = rm12.run(haystack)
    assert rm2.run(rm1.run(haystack)) == got
    want = jamt.Replacer.build(_jcase(case), replaces1).compose(
        jamt.Replacer.build(_jcase(case), replaces2))
    assert got == want.run(haystack) and _pairs(rm12) == _pairs(want)


@given(st.sampled_from(["cs", "ci"]), genHaystack)
@settings(max_examples=40, deadline=None)
def test_identity_for_empty_needles(mode, haystack):
    case = IGNORE_CASE if mode == "ci" else CASE_SENSITIVE
    assert Replacer.build(case, [], device=CPU).run(haystack) == haystack


@given(genHaystack, genReplaces)
@settings(max_examples=100, deadline=None)
def test_equivalent_to_sequential_str_replace(haystack, replaces):
    expected = haystack
    for needle, replacement in replaces:
        expected = expected.replace(needle, replacement)
    assert _run(CASE_SENSITIVE, replaces, haystack) == expected


def test_compose_case_mismatch():
    rm1 = Replacer.build(CASE_SENSITIVE, [("a", "b")], device=CPU)
    assert rm1.compose(Replacer.build(IGNORE_CASE, [("c", "d")], device=CPU)) is None


def test_structure():
    r = Replacer.build(CASE_SENSITIVE, [("a", "x")], device=CPU).map_replacement(lambda b: b * 2)
    assert r.run("aaa") == "xxxxxx" and str(r.searcher.device) == CPU
    r = Replacer.build(CASE_SENSITIVE, [("a", "x")], device=CPU)
    assert r.run("AaA") == "AxA" and r.set_case_sensitivity(IGNORE_CASE).run("AaA") == "xxx"
    assert Replacer.build(CASE_SENSITIVE, [(b"a", b"x")], device=CPU).run(b"aba") == b"xbx"
    assert r == Replacer.build(CASE_SENSITIVE, [("a", "x")], device=CPU)
    assert hash(r) == hash(Replacer.build(CASE_SENSITIVE, [("a", "x")], device=CPU))


def test_json_roundtrip_across_packages():
    hay = "my Tshirt from İSTANBUL tshirt"
    for case in (CASE_SENSITIVE, IGNORE_CASE):
        pairs = [("Tshirt", "X"), ("İstanbul", "Y")]
        r = Replacer.build(case, pairs, device=CPU)
        j = jamt.Replacer.build(_jcase(case), pairs)
        assert r.to_json() == j.to_json()
        back = Replacer.from_json(j.to_json(), device=CPU)
        assert back == r and back.run(hay) == r.run(hay) == j.run(hay)
        assert jamt.Replacer.from_json(r.to_json()) == j
        assert isinstance(back.searcher.needles[0][1], Payload)


def test_npz_artifact_across_packages(tmp_path):
    cases = [(CASE_SENSITIVE, [("tshirt", "TEE"), ("shirts", ""), ("ee", "f")],
              "tshirts, shirts and tees everywhere"),
             (IGNORE_CASE, [("İstanbul", "IST"), ("ß", "ss")], "İSTANBUL straße")]
    for case, pairs, hay in cases:
        r = Replacer.build(case, pairs, device=CPU)
        j = jamt.Replacer.build(_jcase(case), pairs, engine="python")
        r.save_npz(str(tmp_path / "port.npz"))
        j.save_npz(str(tmp_path / "jax.npz"))
        from_jax = Replacer.load_npz(str(tmp_path / "jax.npz"), device=CPU)
        from_port = jamt.Replacer.load_npz(str(tmp_path / "port.npz"), engine="python")
        assert from_jax.searcher.needles == r.searcher.needles
        assert [v for _, v in from_port.searcher.needles] == [v for _, v in j.searcher.needles]
        assert from_jax.case_sensitivity is case
        assert from_jax.run(hay) == from_port.run(hay) == r.run(hay) == j.run(hay)
        assert all(isinstance(v, Payload) for v in from_jax.searcher.automaton.values)
        back = Replacer.load_npz(str(tmp_path / "port.npz"), device=CPU)
        assert back == r and back.run(hay) == r.run(hay)
    p = Payload(-3, 4, 2, b"\x00\xffx")
    assert ac._value_from_json(ac._value_to_json(p)) == p
    assert ac._value_to_json(p) == jamt.models.ac._value_to_json(
        jamt.replacer.Payload(-3, 4, 2, b"\x00\xffx"))


def test_run_on_staged_haystack(native):
    r = Replacer.build(CASE_SENSITIVE, [("tshirt", "TEE"), ("shirts", "SHIRT"), ("ee", "f")],
                       device=CPU)
    text = b"short tshirts and tshirt shirts " * 500
    base = r.run(text)
    staged = r.searcher.stage(text)
    assert staged.device is not None
    assert r.run(staged) == base == jamt.Replacer.build(
        jamt.CASE_SENSITIVE, [("tshirt", "TEE"), ("shirts", "SHIRT"), ("ee", "f")],
        engine="cpp").run(text)
    assert r.run_with_limit(staged, 10) is None
    rci = Replacer.build(IGNORE_CASE, [("istanbul", "CITY"), ("fix", "ok")], device=CPU)
    t2 = "İstanbul FİX fix istanbul ".encode() * 300
    st2 = rci.searcher.stage(t2)
    assert st2.composed and st2.device is not None
    assert rci.run(st2) == rci.run(t2) == jamt.Replacer.build(
        jamt.IGNORE_CASE, [("istanbul", "CITY"), ("fix", "ok")], engine="cpp").run(t2)


def test_run_on_lowered_staged_haystack_rejected(monkeypatch):
    monkeypatch.setattr(tengine, "COMPOSED_CI_MAX_STATES", 0)  # the lowering path
    r = Replacer.build(IGNORE_CASE, [("istanbul", "CITY")], device=CPU)
    staged = r.searcher.stage("İstanbul visit")
    assert staged.lowered is not None and not staged.composed
    with pytest.raises(ValueError, match="lowered bytes"):
        r.run(staged)
    assert r.run("İstanbul visit") == "CITY visit"


# -- test_replacer_incremental.py ---------------------------------------------------


def both_ways(case, replaces, haystack, monkeypatch, engine="python"):
    """The incremental loop and the full-rescan loop of the port agree, and
    agree with the JAX package's scalar engine."""
    monkeypatch.setattr(trep, "INCREMENTAL", True)
    inc = Replacer.build(case, replaces, engine=engine, device=CPU).run(haystack)
    monkeypatch.setattr(trep, "INCREMENTAL", False)
    full = Replacer.build(case, replaces, engine=engine, device=CPU).run(haystack)
    assert inc == full, (replaces, haystack[:80])
    assert inc == jamt.Replacer.build(_jcase(case), replaces, engine="python").run(haystack)
    return inc


def test_cascading_lower_priority_matches(monkeypatch, native):
    out = both_ways(CASE_SENSITIVE, [("foo", "barbar"), ("bar", "baz"), ("zb", "Q")],
                    "foo x foo bar", monkeypatch)
    assert "foo" not in out


def test_empty_replacement_joins_new_matches(monkeypatch, native):
    both_ways(CASE_SENSITIVE, [("xx", ""), ("ab", "<AB>")], "axxb  axxb  ab xxab", monkeypatch)


def test_overlap_and_priority_order(monkeypatch, native):
    both_ways(CASE_SENSITIVE, [("aa", "zz"), ("bb", "w"), ("zzw", "!")],
              "aaabbb aab abab aaaa", monkeypatch)


def test_fuzz_case_sensitive(monkeypatch):
    rng = random.Random(99)
    for _ in range(40):
        needles = list({"".join(rng.choice("ab") for _ in range(rng.randint(1, 3)))
                        for _ in range(rng.randint(1, 4))})
        repls = [(n, "".join(rng.choice("ab") for _ in range(rng.randint(0, 3)))) for n in needles]
        hay = "".join(rng.choice("ab") for _ in range(rng.randint(0, 120)))
        both_ways(CASE_SENSITIVE, repls, hay, monkeypatch)


def test_fuzz_ignore_case_composed(monkeypatch):
    monkeypatch.setattr(tengine.MatchEngine, "AUTO_COMPOSE_BYTES", 0)
    rng = random.Random(7)
    alpha = "aAßẞkKİi"
    for _ in range(15):
        needles = list({utf8.lower_str("".join(rng.choice(alpha) for _ in range(rng.randint(1, 3))))
                        for _ in range(rng.randint(1, 3))})
        repls = [(n, "".join(rng.choice(alpha) for _ in range(rng.randint(0, 2)))) for n in needles]
        hay = "".join(rng.choice(alpha) for _ in range(rng.randint(0, 80)))
        both_ways(IGNORE_CASE, repls, hay, monkeypatch)


def test_ignore_case_kelvin_byte_shrink(monkeypatch, native):
    monkeypatch.setattr(tengine.MatchEngine, "AUTO_COMPOSE_BYTES", 0)
    both_ways(IGNORE_CASE, [("ka", "X"), ("xk", "<>")], "Ka ka KA xK xk İk Ka", monkeypatch)


def test_run_with_limit_budget(monkeypatch):
    for flag in (True, False):
        monkeypatch.setattr(trep, "INCREMENTAL", flag)
        r = Replacer.build(CASE_SENSITIVE, [("a", "bbbb")], device=CPU)
        assert r.run_with_limit("aaaa", 6) is None
        assert r.run_with_limit("aaaa", 16) == "bbbbbbbbbbbbbbbb"
        q = Replacer.build(CASE_SENSITIVE, [("a", "QQQQ")], device=CPU)
        assert q.run_with_limit("aaaa", 6) is None
        assert q.run_with_limit("aaaa", 16) == "Q" * 16


def test_large_input_windows_path(monkeypatch, native):
    rng = random.Random(3)
    filler = "".join(rng.choice("qwrtypsdfghjkl ") for _ in range(200_000))
    hay = (filler[:50_000] + " tshirt " + filler[50_000:100_000] + " shirts shorts "
           + filler[100_000:])
    out = both_ways(CASE_SENSITIVE,
                    [("tshirt", "TEE"), ("shirts", "S"), ("ee", "f"), ("short", "sh")],
                    hay, monkeypatch, engine="cpp")
    assert "tshirt" not in out


def test_batched_eligibility():
    def elig(case, pairs, vids):
        got = Replacer.build(case, pairs, device=CPU)._no_creation_eligible(np.array(vids))
        want = jamt.Replacer.build(_jcase(case), pairs)._no_creation_eligible(np.array(vids))
        assert got == want
        return got

    assert elig(CASE_SENSITIVE, [("abc", "XY"), ("bd", "Z")], [0, 1])
    assert not elig(CASE_SENSITIVE, [("abc", "Xa"), ("bd", "Z")], [0, 1])
    assert not elig(CASE_SENSITIVE, [("abc", ""), ("bd", "Z")], [0, 1])
    assert not elig(IGNORE_CASE, [("xy", "X")], [0])
    assert elig(IGNORE_CASE, [("xy", "Q9")], [0])


def test_batched_matches_sequential(monkeypatch, native):
    assert both_ways(CASE_SENSITIVE, [("aba", "X"), ("ab", "YY"), ("b", "Z")],
                     "abababa b ab aba", monkeypatch) == "XZX Z YY X"
    assert both_ways(CASE_SENSITIVE, [("abc", "X"), ("cd", "Y")], "abcd cd abc",
                     monkeypatch) == "Xd Y X"


@pytest.mark.parametrize("needles,text,want", [
    ([("", "X")], "abcab", "abcab"),
    ([("", "X"), ("ab", "Y")], "abcab", "aXbXcaXbX"),
    ([("ab", "Y"), ("", "-")], "abcab", "YcY"),
    ([("", "X"), ("ab", "Y")], "aßb", "aXßb"),
])
def test_empty_needle_three_way_agreement(needles, text, want, monkeypatch):
    assert both_ways(CASE_SENSITIVE, needles, text, monkeypatch) == want
    assert Replacer.build(CASE_SENSITIVE, needles, engine="python", device=CPU).run(text) == want


# -- the pass paths on the device backend (the kernels' plain versions) ---------------


def _spy(monkeypatch):
    """Counts of the pass paths a run takes: the batched splice, window
    rescans, device scans (``MatchEngine.matches`` on the device backend)."""
    calls = {"batched": 0, "windows": 0, "device_scans": 0, "full_loop_scans": 0}
    batched, windows = trep.Replacer._run_batched, trep.Replacer._scan_windows
    matches = tengine.MatchEngine.matches

    def run_batched(self, *a, **k):
        calls["batched"] += 1
        return batched(self, *a, **k)

    def scan_windows(self, *a, **k):
        calls["windows"] += 1
        return windows(self, *a, **k)

    def spy_matches(self, text, case):
        if isinstance(text, tengine.StagedHaystack) or len(text) >= tengine.AUTO_PYTHON_THRESHOLD:
            calls["device_scans"] += self.engine in ("auto", "device")
        calls["full_loop_scans"] += not trep.INCREMENTAL
        return matches(self, text, case)

    monkeypatch.setattr(trep.Replacer, "_run_batched", run_batched)
    monkeypatch.setattr(trep.Replacer, "_scan_windows", scan_windows)
    monkeypatch.setattr(tengine.MatchEngine, "matches", spy_matches)
    return calls


def _sequential(pairs, data: bytes) -> bytes:
    """The reference's semantics: ``replace`` per needle in build order."""
    for n, r in pairs:
        data = data.replace(n.encode(), r.encode())
    return data


@pytest.mark.parametrize("path", ["batched", "windows", "full_rescan_in_loop", "no_incremental"])
def test_device_pass_paths(monkeypatch, native, path):
    pairs, frac = {"batched": (CONFIG4, 0.01), "windows": (CASCADE, 0.01),
                   "full_rescan_in_loop": (CASCADE, 0.6), "no_incremental": (CASCADE, 0.05)}[path]
    if path == "no_incremental":
        monkeypatch.setattr(trep, "INCREMENTAL", False)
    hay = synth_corpus(["tshirt", "shirts", "shorts"], 1 << 15, hit_fraction=frac, seed=9)
    calls = _spy(monkeypatch)
    r = Replacer.build(CASE_SENSITIVE, pairs, device=CPU)
    one_shot = r.run(hay)
    staged = r.run(r.searcher.stage(hay))
    calls = dict(calls)  # the two runs on the device backend
    want = _sequential(pairs, hay)
    assert one_shot == staged == want
    assert want == jamt.Replacer.build(jamt.CASE_SENSITIVE, pairs, engine="cpp").run(hay)
    assert want == Replacer.build(CASE_SENSITIVE, pairs, engine="cpp", device=CPU).run(hay)
    if path == "batched":
        assert calls["batched"] == 2 and calls["windows"] == 0 and calls["device_scans"] == 2
    elif path == "windows":
        assert calls["batched"] == 0 and calls["windows"] == 4 and calls["device_scans"] == 2
    elif path == "full_rescan_in_loop":
        assert calls["batched"] == 0 and calls["device_scans"] > 2  # a rescan on the device
    else:
        assert calls["full_loop_scans"] >= 6 and calls["batched"] == calls["windows"] == 0
    limit = len(want) - 1
    assert r.run_with_limit(hay, limit) is None or len(want) <= limit


def test_config2_upper_case_on_comb16(monkeypatch):
    pairs = [(n, n.upper()) for n in CONFIG2]
    hay = synth_corpus(CONFIG2, 1 << 14, hit_fraction=0.05, seed=2)
    calls = _spy(monkeypatch)
    r = Replacer.build(CASE_SENSITIVE, pairs, device=CPU)
    got = r.run(r.searcher.stage(hay))
    assert type(r.searcher._engine.device_engine()).__name__ == "Comb16AcEngine"
    assert got == _sequential(pairs, hay) == jamt.Replacer.build(
        jamt.CASE_SENSITIVE, pairs, engine="cpp").run(hay)
    assert calls["batched"] == 1 and got != hay


def _scramble(text: bytes, seed: int) -> bytes:
    a = np.frombuffer(text, np.uint8).copy()
    up = (a >= 97) & (a <= 122) & (np.random.default_rng(seed).random(len(a)) < 0.5)
    a[up] -= 32
    return a.tobytes()


@pytest.mark.parametrize("pairs", [CONFIG4, CASCADE], ids=["config4", "cascade"])
def test_ignore_case_staged_and_lowered(monkeypatch, native, pairs):
    hay = _scramble(synth_corpus(["tshirt", "shirts", "shorts"], 1 << 14, hit_fraction=0.02,
                                 seed=3), 3) + "KİLO TSHİRT tshırt".encode()
    r = Replacer.build(IGNORE_CASE, pairs, device=CPU)
    want = jamt.Replacer.build(jamt.IGNORE_CASE, pairs, engine="cpp").run(hay)
    assert want == jamt.Replacer.build(jamt.IGNORE_CASE, pairs, engine="python").run(hay)
    lowered = r.run(hay)  # one-shot under AUTO_COMPOSE_BYTES: the lowering path, full rescans
    assert r.searcher._engine._ci is False and lowered == want
    st = r.searcher.stage(hay)
    assert st.composed and st.device is not None
    assert r.run(st) == want
    assert Replacer.build(IGNORE_CASE, pairs, engine="cpp", device=CPU).run(hay) == want


def test_lowering_fallback_scans_every_pass(monkeypatch):
    calls = _spy(monkeypatch)
    r = Replacer.build(IGNORE_CASE, CASCADE, device=CPU)
    hay = b"TSHIRT shirts Shorts " * 300
    assert r.run(hay) == jamt.Replacer.build(jamt.IGNORE_CASE, CASCADE, engine="cpp").run(hay)
    assert calls["device_scans"] == 3 and calls["windows"] == 0
