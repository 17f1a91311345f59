"""The port's ``Splitter`` against the JAX package's.

Mirrors ``tests/test_splitter.py``: every split runs the port's
``Splitter`` on ``device="cpu"`` and the JAX ``Splitter`` on the same
haystack and holds the fragments equal, and equal to the reference's answer
where the JAX test states one.  Haystacks of 4 KiB and more take the
device backend (the kernels' plain versions); IgnoreCase ones of
``AUTO_COMPOSE_BYTES`` and more, or with that threshold monkeypatched to 0,
the composed case DFA, and smaller ones the lowering path.  Tolerance:
exact equality of every fragment list.
"""

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import alfred_margaret_tpu as jamt

from alfred_margaret_tpu_torch import Splitter
from alfred_margaret_tpu_torch import engine as tengine
from alfred_margaret_tpu_torch.bench.dataformat import synth_corpus
from _torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

CPU = "cpu"


def _both(sep, haystack, ci=False, engine="auto"):
    got_sp = Splitter.build(sep, engine=engine, device=CPU)
    want_sp = jamt.Splitter.build(sep, engine="cpp" if engine == "auto" else engine)
    if ci:
        got, want = got_sp.split_ignore_case(haystack), want_sp.split_ignore_case(haystack)
    else:
        got, want = got_sp.split(haystack), want_sp.split(haystack)
    assert got == want
    return got


def test_overlapping_separators_example():
    assert _both("bob", "C++bobobCOBOLbobScala") == ["C++", "obCOBOL", "Scala"]
    assert _both("bob", "C++bobobCOBOLbobScala", ci=True) == ["C++", "obCOBOL", "Scala"]
    assert _both("bob", "C++BOBOBCOBOLBOBSCALA", ci=True) == ["C++", "OBCOBOL", "SCALA"]


def test_iliad():
    line = "Ἄνδρα μοι ἔννεπε, Μοῦσα, πολύτροπον, ὃς μάλα πολλὰ"
    expected = ["Ἄνδρα μοι ἔννεπε", "Μοῦσα", "πολύτροπον", "ὃς μάλα πολλὰ"]
    assert _both(", ", line) == expected
    assert _both(", ", line, ci=True) == expected


def test_case_insensitive_variable_byte_lengths():
    assert _both("å", "aaåbbÅccÅdd", ci=True) == ["aa", "bb", "cc", "dd"]


def test_no_separator_yields_whole():
    assert _both("x", "hello") == ["hello"]
    assert _both("x", "") == [""]


def test_reverse_variants():
    sp, jsp = Splitter.build("-", device=CPU), jamt.Splitter.build("-")
    assert sp.split_reverse("a-b-c") == jsp.split_reverse("a-b-c") == ["c", "b", "a"]
    assert sp.split_reverse_ignore_case("a-b-c") == jsp.split_reverse_ignore_case("a-b-c")


@given(st.text(alphabet="ab-", max_size=40))
@settings(max_examples=100, deadline=None)
def test_equivalent_to_str_split_single_char(haystack):
    assert _both("-", haystack) == haystack.split("-")


@given(st.text(alphabet="ab", min_size=1, max_size=3), st.text(alphabet="ab", max_size=30))
@settings(max_examples=100, deadline=None)
def test_join_roundtrip(sep, haystack):
    parts = _both(sep, haystack)
    assert sep.join(parts) == haystack or sep not in haystack
    assert parts == haystack.split(sep)


def test_structure():
    a = Splitter.build("x", device=CPU)
    assert a == Splitter.build("x", device=CPU) and hash(a) == hash(Splitter.build("x", device=CPU))
    assert a != Splitter.build("y", device=CPU)
    assert a.separator == b"x" and a.automaton.n_states == 2
    assert Splitter.from_json(a.to_json(), device=CPU) == a
    assert a.to_json() == jamt.Splitter.build("x").to_json()
    assert Splitter.from_json(jamt.Splitter.build("é").to_json(), device=CPU).separator == "é".encode()
    assert repr(a) == repr(jamt.Splitter.build("x"))


def test_bytes_separator_non_utf8():
    assert _both(b"\xff", b"a\xffb\xffc") == [b"a", b"b", b"c"]


@pytest.mark.parametrize("sep", ["shorts", "tshirt", "s", "ab"])
def test_device_backend_matches_jax(sep):
    """A corpus over the device threshold: the port's plain kernels against
    the JAX host engine, case-sensitively and on the lowering path."""
    hay = synth_corpus(["tshirt", "shirts", "shorts"], 1 << 14, hit_fraction=0.05, seed=5)
    got = _both(sep, hay)
    assert got == hay.split(sep.encode())
    assert [f.lower() for f in _both(sep, hay.upper(), ci=True)] == got


@pytest.mark.parametrize("sep", ["shorts", "k", "straße", "i"])
def test_composed_ignore_case_matches_jax(monkeypatch, sep):
    monkeypatch.setattr(tengine.MatchEngine, "AUTO_COMPOSE_BYTES", 0)
    words = ["tshirt", "shirts", "shorts", "Kelvin", "KELVIN", "STRAẞE", "straße", "İSTANBUL"]
    hay = synth_corpus(words, 1 << 13, hit_fraction=0.1, seed=6)
    sp = Splitter.build(sep, device=CPU)
    got = sp.split_ignore_case(hay)
    assert sp._engine._ci not in (False, None)  # the composed engine answered
    assert got == jamt.Splitter.build(sep, engine="cpp").split_ignore_case(hay)
    assert got == jamt.Splitter.build(sep, engine="python").split_ignore_case(hay)
    assert len(got) > 1
