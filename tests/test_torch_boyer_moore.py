"""The port's Boyer-Moore and Boyer-MooreCI copies against the JAX package's.

Mirrors ``tests/test_boyer_moore.py`` and ``tests/test_boyer_moore_ci.py``
test for test: each runs the port's ``boyer_moore`` / ``boyer_moore_ci``
(automaton, skip tables, classic loop, replacer, searcher) and the JAX
package's on the same inputs, hypothesis-drawn or fixed, and holds the two
equal and equal to the reference's answer where the JAX test states one.
Both families scan on the host; the searchers' AC route (haystacks over
``AC_ROUTE_THRESHOLD``) is the port's ``Searcher`` on the searcher's
``device``, here ``"cpu"``, where the device engine's plain versions run.
Tolerance: exact equality of every match list, flag and output.
"""

import numpy as np
from hypothesis import given, settings
from hypothesis import strategies as st

import alfred_margaret_tpu as jamt
from alfred_margaret_tpu import boyer_moore as jbm
from alfred_margaret_tpu import boyer_moore_ci as jbmci
from alfred_margaret_tpu.boyer_moore import automaton as jbm_auto
from alfred_margaret_tpu.boyer_moore_ci import automaton as jbmci_auto
from alfred_margaret_tpu.models import ac as jac

from alfred_margaret_tpu_torch import CASE_SENSITIVE, IGNORE_CASE, Replacer
from alfred_margaret_tpu_torch import boyer_moore as bm
from alfred_margaret_tpu_torch import boyer_moore_ci as bmci
from alfred_margaret_tpu_torch.boyer_moore import automaton as bm_auto
from alfred_margaret_tpu_torch.boyer_moore_ci import automaton as bmci_auto
from alfred_margaret_tpu_torch.models.ac import Done, Step
from alfred_margaret_tpu_torch.utils import utf8


def _ends(mod, needle, haystack):
    auto = mod.build_automaton(needle)
    return [s + mod.pattern_length(auto) for s in mod.matches(auto, haystack)]


def match_end_positions(needle, haystack):
    got = _ends(bm_auto, needle, haystack)
    assert got == _ends(jbm_auto, needle, haystack)
    return got


def match_positions(needle, haystack):
    got = bmci_auto.matches(bmci_auto.build_automaton(needle), haystack)
    assert got == jbmci_auto.matches(jbmci_auto.build_automaton(needle), haystack)
    return got


def match_texts(needle, haystack):
    hay = utf8.to_bytes(haystack)
    return [hay[frm:to + 1].decode("utf-8") for frm, to in match_positions(needle, haystack)]


def naive_match_positions(needle, haystack):
    nb, hb = needle.encode(), haystack.encode()
    out, start = [], 0
    while nb:
        i = hb.find(nb, start)
        if i < 0:
            break
        out.append(i + len(nb))
        start = i + len(nb)
    return out


@st.composite
def needle_haystack(draw, alphabets=("abAB12", "aAБВ\U0001d11e\U0001f4a9ßẞÅå"), hay_max=20):
    alphabet = draw(st.sampled_from(list(alphabets)))
    fragments = draw(st.lists(st.text(alphabet=alphabet, min_size=1, max_size=3), min_size=1,
                              max_size=4))
    frag = st.sampled_from(fragments)
    needle = draw(st.builds("".join, st.lists(frag, min_size=1, max_size=2)))
    haystack = draw(st.builds("".join, st.lists(frag, max_size=hay_max)))
    return needle, haystack


# -- Boyer-Moore (tests/test_boyer_moore.py) ----------------------------------------


def test_bm_needle_equals_haystack_repeated_char():
    for n in range(1, 129):
        assert match_end_positions("a" * n, "a" * n) == [n]


def test_bm_needle_equals_haystack_non_bmp():
    for t in ["\U000437b8suffix", "aaa\U00057bab" + "aaa\U00017607aa\U000db938aa"]:
        assert match_end_positions(t, t) == [len(t.encode())]


def test_bm_non_ascii():
    assert match_end_positions("eclair", "éclaireclair") == [13]
    assert match_end_positions("éclair", "éclaireclair") == [7]
    assert match_end_positions("éclair", "eclairéclair") == [13]


def test_bm_complex_characters():
    assert match_end_positions("\U0001d11e", "\U0001d11e") == [4]
    woman = "\U0001f574\U0001f3ff‍♀️"
    for needle, end_pos in [(woman, 17), ("\U0001f574\U0001f3ff", 8), ("\U0001f574", 4)]:
        assert match_end_positions(needle, woman) == [end_pos]


def test_bm_empty_needle_no_match():
    assert match_end_positions("", "") == []
    assert match_end_positions("", "foo") == []


def test_bm_kitchen_sink():
    assert match_end_positions('"\x0e]JL"', 'aaaaa"\x0e]JL"') == [11]
    assert match_end_positions('"X]JL"', 'aaaaa"X]JL"') == [11]


@given(needle_haystack())
@settings(max_examples=150, deadline=None)
def test_bm_only_infixes(nh):
    needle, haystack = nh
    hay, nb = haystack.encode(), needle.encode()
    auto = bm.build_automaton(needle)
    starts = bm_auto.matches(auto, haystack)
    assert starts == jbm_auto.matches(jbm.build_automaton(needle), haystack)
    for start in starts:
        assert hay[start:start + len(nb)] == nb


@given(needle_haystack())
@settings(max_examples=150, deadline=None)
def test_bm_all_infixes(nh):
    needle, haystack = nh
    assert match_end_positions(needle, haystack) == naive_match_positions(needle, haystack)


@given(needle_haystack())
@settings(max_examples=100, deadline=None)
def test_bm_classic_loop_equals_find_loop(nh):
    needle, haystack = nh

    def collect(run, auto, step):
        out = []
        run(out, lambda acc, pos: (acc.append(pos), step(acc))[1], auto, haystack)
        return out

    auto, jauto = bm.build_automaton(needle), jbm.build_automaton(needle)
    got = collect(bm_auto.run_text, auto, Step)
    assert got == collect(bm_auto.run_text_classic, auto, Step)
    assert got == collect(jbm_auto.run_text_classic, jauto, jac.Step)
    assert auto.pattern == jauto.pattern
    np.testing.assert_array_equal(auto.suffix_table, jauto.suffix_table)
    np.testing.assert_array_equal(auto.bad_char_table, jauto.bad_char_table)


def test_bm_early_exit():
    got = bm.run_text(None, lambda acc, pos: Done(pos), bm.build_automaton("a"), "xxaxa")
    want = jbm.run_text(None, lambda acc, pos: jac.Done(pos), jbm.build_automaton("a"), "xxaxa")
    assert got == want == 2


@given(needle_haystack(), st.text(max_size=5))
@settings(max_examples=100, deadline=None)
def test_bm_replacer_equivalent_to_ac_replacer(nh, replacement):
    needle, haystack = nh
    want = jamt.Replacer.build(jamt.CASE_SENSITIVE, [(needle, replacement)]).run(haystack)
    port_ac = Replacer.build(CASE_SENSITIVE, [(needle, replacement)], device="cpu").run(haystack)
    got = bm.replace_single_limited(bm.build_automaton(needle), replacement, haystack)
    assert got == port_ac == want
    assert got == jbm.replace_single_limited(jbm.build_automaton(needle), replacement, haystack)


def test_bm_replacer_limit():
    for mod in (bm, jbm):
        auto = mod.build_automaton("a")
        assert mod.replace_single_limited(auto, "xxxx", "aa", max_length=8) == "xxxxxxxx"
        assert mod.replace_single_limited(auto, "xxxx", "aa", max_length=7) is None


def test_bm_replacer_empty_needle():
    for mod in (bm, jbm):
        auto = mod.build_automaton("")
        assert mod.replace_single_limited(auto, "r", "") == "r"
        assert mod.replace_single_limited(auto, "r", "keep") == "keep"


@given(st.lists(st.text(max_size=3), max_size=4), st.text(max_size=30))
@settings(max_examples=150, deadline=None)
def test_bm_searcher_contains_any_equiv(needles, haystack):
    got = bm.Searcher.build(needles, device="cpu").contains_any(haystack)
    assert got is jbm.Searcher.build(needles).contains_any(haystack)
    assert got is any(n and n in haystack for n in needles)


@given(st.lists(st.text(max_size=3), max_size=4), st.text(max_size=30))
@settings(max_examples=150, deadline=None)
def test_bm_searcher_contains_all_equiv(needles, haystack):
    got = bm.Searcher.build_needle_id_searcher(needles, device="cpu").contains_all(haystack)
    assert got is jbm.Searcher.build_needle_id_searcher(needles).contains_all(haystack)
    assert got is all(n and n in haystack for n in needles)


def test_bm_searcher_large_haystack_ac_route():
    hay = "x" * 100_000 + "needle" + "y" * 100_000
    for mod, kw in ((bm, {"device": "cpu"}), (jbm, {})):
        s = mod.Searcher.build(["needle", "absent"], **kw)
        assert s.contains_any(hay) is True
        assert s.contains_all(hay) is False
        assert mod.Searcher.build_needle_id_searcher(["needle", "x", "y"], **kw).contains_all(hay)
    # The AC route keeps the searcher's engine and device: under "auto" a
    # haystack this size takes the device engine (here its plain versions).
    for engine in ("auto", "device", "cpp"):
        s = bm.Searcher.build(["needle", "absent"], engine=engine, device="cpu")
        assert s.contains_any(hay) is True and s.contains_all(hay) is False
        ac = s._ac_searcher()
        assert str(ac.device) == "cpu" and ac._engine.engine == engine
        assert ac._engine._pick(len(hay)) == ("device" if engine == "auto" else engine)


# -- Boyer-MooreCI (tests/test_boyer_moore_ci.py) -----------------------------------


def test_bmci_basic():
    assert match_positions("abc", "ABCA") == [(0, 2)]
    assert match_positions("bc", "abca") == [(1, 2)]
    assert match_positions("bc", "ABCA") == [(1, 2)]


def test_bmci_no_overlapping():
    assert match_positions("aba", "abababa") == [(0, 2), (4, 6)]
    assert match_positions("aba", "ABaBaBA") == [(0, 2), (4, 6)]


def test_bmci_uppercase_needles_dont_match():
    assert match_positions("A", "aaaa") == []
    assert match_positions("A", "AAAA") == []


def test_bmci_cyrillic():
    assert match_positions("п", "ипсум") == [(2, 3)]
    assert match_positions("п", "ИПСУМ") == [(2, 3)]
    assert match_positions("лорем", "Лорем") == [(0, 9)]
    assert match_texts("лорем", "ЛОРЕМ") == ["ЛОРЕМ"]
    assert match_texts("сит", "итсит") == ["сит"]
    assert match_texts("сит", "ИТСИТ") == ["СИТ"]


def test_bmci_mixed_byte_lengths():
    assert match_texts("сит", "Лорем ипсум долор сит амет") == ["сит"]
    assert match_texts("сит", "ЛОРЕМ ИПСУМ ДОЛОР СИТ АМЕТ") == ["СИТ"]
    zoo = "ЛОРЕМab\U0001d11e\U0001f4a9\U0001d11eДОЛab\U0001f4a9baåÅÅ\U0001d11e\U0001d11eßẞ"
    assert match_texts("\U0001f4a9b", zoo) == ["\U0001f4a9b"]
    assert match_texts("\U0001d11e", zoo) == ["\U0001d11e"] * 4
    assert match_texts("a", zoo) == ["a"] * 3


def test_bmci_shrinking_case_variants():
    assert match_positions("ⱥⱦⱥⱦⱥⱦ", "ⱥⱦⱥⱦⱥⱦ") == [(0, 17)]
    assert match_positions("ⱥⱦⱥⱦⱥⱦ", "ȺȾȺȾȺȾ") == [(0, 11)]
    assert match_texts("ⱥⱦⱥⱦⱥⱦ", "ȺⱦⱥȾⱥȾ") == ["ȺⱦⱥȾⱥȾ"]


def test_bmci_needle_equals_haystack():
    for n in range(1, 129):
        assert match_positions("a" * n, "a" * n) == [(0, n - 1)]


@given(st.text(alphabet="aAБВ\U0001d11e\U0001f4a9ßẞÅå", min_size=1, max_size=10))
@settings(max_examples=100, deadline=None)
def test_bmci_needle_is_lowered_haystack(text):
    assert match_positions(utf8.lower_str(text), text) == [(0, len(text.encode()) - 1)]


def test_bmci_gross():
    assert match_texts("groß", "Großfräsmaschinenöffnungstür") == ["Groß"]
    assert match_texts("groß", "GROẞFRÄSMASCHINENÖFFNUNGSTÜR") == ["GROẞ"]
    assert match_texts("öffnung", "GROẞFRÄSMASCHINENÖFFNUNGSTÜR") == ["ÖFFNUNG"]


def test_bmci_minimum_skip_docstring_values():
    for ch, want in (("a", 1), ("д", 2), ("ⓟ", 3), ("\U0001f384", 4), ("ⱥ", 2), ("ⱦ", 2)):
        assert bmci.minimum_skip_for_code_point(ord(ch)) == want
        assert jbmci.minimum_skip_for_code_point(ord(ch)) == want


def test_bmci_minimum_skip_full_unicode():
    cps = list(range(0x3000)) + [0x1E9E, 0x212A, 0x212B, 0x2C65, 0x2C66, 0x2C6F, 0x10400]
    got = [bmci.minimum_skip_for_code_point(cp) for cp in cps]
    assert got == [jbmci.minimum_skip_for_code_point(cp) for cp in cps]
    for cp, skip in zip(cps, got):
        variants = utf8.unlower_code_point(chr(cp))
        assert skip == (min(utf8.num_code_units(ord(u)) for u in variants) if variants
                        else utf8.num_code_units(cp))


@given(st.lists(st.text(max_size=3), max_size=4), st.text(max_size=30))
@settings(max_examples=100, deadline=None)
def test_bmci_searcher_contains_any_equiv(needles, haystack):
    lneedles = [utf8.lower_str(n) for n in needles]
    got = bmci.Searcher.build(lneedles, device="cpu").contains_any(haystack)
    assert got is jbmci.Searcher.build(lneedles).contains_any(haystack)
    lhay = utf8.lower_str(haystack)
    assert got is any(n and n in lhay for n in lneedles)


@given(st.lists(st.text(max_size=3), max_size=4), st.text(max_size=30))
@settings(max_examples=100, deadline=None)
def test_bmci_searcher_contains_all_equiv(needles, haystack):
    lneedles = [utf8.lower_str(n) for n in needles]
    got = bmci.Searcher.build_needle_id_searcher(lneedles, device="cpu").contains_all(haystack)
    assert got is jbmci.Searcher.build_needle_id_searcher(lneedles).contains_all(haystack)
    lhay = utf8.lower_str(haystack)
    assert got is all(n and n in lhay for n in lneedles)


def test_bmci_searcher_large_haystack_ac_route():
    hay = "X" * 70_000 + "KELVIN straẞe" + "y" * 70_000
    for needles in (["kelvin", "absent"], ["kelvin", "straße"], ["k"]):
        got = bmci.Searcher.build_needle_id_searcher(needles, device="cpu")
        want = jbmci.Searcher.build_needle_id_searcher(needles)
        assert got.contains_any(hay) is want.contains_any(hay)
        assert got.contains_all(hay) is want.contains_all(hay)
        ac = got._ac_searcher()
        assert str(ac.device) == "cpu" and ac._engine._pick(len(hay)) == "device"


@given(needle_haystack(alphabets=("abAB12", "aAБВ\U0001d11e\U0001f4a9ßẞÅå", "ȺⱥȾⱦiİ"),
                       hay_max=15), st.text(max_size=4))
@settings(max_examples=150, deadline=None)
def test_bmci_replacer_equivalent_to_ac_replacer(nh, replacement):
    needle, haystack = nh
    lneedle = utf8.lower_str(needle)
    want = jamt.Replacer.build(jamt.IGNORE_CASE, [(lneedle, replacement)]).run(haystack)
    port_ac = Replacer.build(IGNORE_CASE, [(lneedle, replacement)], device="cpu").run(haystack)
    got = bmci.replace_single_limited(bmci.build_automaton(lneedle), replacement, haystack)
    assert got == port_ac == want
    assert got == jbmci.replace_single_limited(jbmci.build_automaton(lneedle), replacement,
                                               haystack)


def test_bmci_suffix_table_worked_example():
    cps = tuple(ord(c) for c in "ababa")
    assert bmci_auto.build_suffix_table(cps) == jbmci_auto.build_suffix_table(cps) == [2, 2, 4, 4, 1]


def test_bmci_substring_is_suffix_examples():
    for text in ("ababa", "baba", "abaacbbaac", "abaacaabcbaac"):
        cps = tuple(ord(c) for c in text)
        got = [bmci_auto._substring_is_suffix(cps, p) for p in range(len(cps))]
        assert got == [jbmci_auto._substring_is_suffix(cps, p) for p in range(len(cps))]
    s2 = tuple(ord(c) for c in "abaacaabcbaac")
    assert bmci_auto._substring_is_suffix(s2, 4) == 4
    assert bmci_auto._substring_is_suffix(s2, 8) == 1


def test_bmci_bad_char_table():
    for text in ("adcd", "aд💩x"):
        cps = tuple(ord(c) for c in text)
        table, spill, default = bmci_auto.build_bad_char(cps)
        jtable, jspill, jdefault = jbmci_auto.build_bad_char(cps)
        assert list(table) == list(jtable) and spill == jspill and default == jdefault
    table, _, default = bmci_auto.build_bad_char(tuple(ord(c) for c in "adcd"))
    assert default == 4 and table[ord("a")] == 3 and table[ord("d")] == 2


def test_bmci_classic_equals_default_engine():
    rng = np.random.default_rng(31)
    alphabet = list("abAB12ßẞİiKkÅå") + ["д", "Д", "ⱥ", "Ⱥ", "ⱦ", "Ⱦ", "💩", "𝄞"]
    for _ in range(60):
        needle = utf8.lower_str("".join(rng.choice(alphabet, size=int(rng.integers(1, 5)))))
        hay = "".join(rng.choice(alphabet, size=int(rng.integers(0, 60))))
        a = bmci.build_automaton(needle)
        got = bmci_auto.matches_classic(a, hay)
        assert got == bmci_auto.matches(a, hay), (needle, hay)
        assert got == jbmci_auto.matches_classic(jbmci.build_automaton(needle), hay)


def test_bmci_classic_goldens():
    a = bmci.build_automaton("дом")
    assert bmci_auto.matches_classic(a, "ДОМ дом Дом") == [(0, 5), (7, 12), (14, 19)]
    assert bmci_auto.matches_classic(bmci.build_automaton("ⱥb"), "Ⱥb xⱥb") == [(0, 2), (5, 8)]
    a3 = bmci.build_automaton("aa")
    assert bmci_auto.matches_classic(a3, "aaaa") == [(0, 1), (2, 3)]
    hits = []

    def first(acc, frm, to):
        hits.append((frm, to))
        return Done(acc)

    bmci_auto.run_text_classic(None, first, a3, "aaaa")
    assert hits == [(0, 1)]


def test_bmci_classic_invalid_bytes():
    hay = b"\xffab \x80ab \xc2ab \xe0\x80ab"
    a = bmci.build_automaton("ab")
    got = bmci_auto.matches_classic(a, hay)
    assert got == bmci_auto.matches(a, hay)
    assert got == jbmci_auto.matches_classic(jbmci.build_automaton("ab"), hay)
