"""The port's host prefilter-verify engine (``native/prefilter.py``, large
needle sets of needles of 5 bytes or more) against the JAX package's.

Mirrors ``tests/test_prefilter.py``: every count and first hit of the port's
``PrefilterEngine`` (the port's ``am_prefilter_count`` and
``am_prefilter_first``) equals the JAX engine's on the JAX package's library
and the automaton's count; the tables the two engines build are equal
array for array.  Tolerance: exact equality.
"""

import numpy as np
import pytest

import alfred_margaret_tpu as jamt
from alfred_margaret_tpu.models import ac as jac
from alfred_margaret_tpu.native import prefilter as jprefilter
from alfred_margaret_tpu.native.build import NativeUnavailable
from alfred_margaret_tpu.native.cpp_engine import CppAcEngine as JaxCpp

from alfred_margaret_tpu_torch import CASE_SENSITIVE, IGNORE_CASE, MatchEngine, Searcher
from alfred_margaret_tpu_torch.bench.dataformat import synth_corpus
from alfred_margaret_tpu_torch.native import prefilter

TABLES = ("_bloom", "_keys", "_grp_off", "_grp_needles", "_nb_off", "_nb_bytes")


def _engines(needles):
    """The port's engine and the JAX package's, their tables equal."""
    got = prefilter.PrefilterEngine(needles)
    try:
        want = jprefilter.PrefilterEngine(needles)
    except NativeUnavailable:
        pytest.skip("the JAX package's native library does not build here")
    for name in TABLES:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    assert (got._bloom_words, got._slots) == (want._bloom_words, want._slots)
    return got, want


def _count(needles, hay):
    return jac.count_matches(jac.build([(n, i) for i, n in enumerate(needles)]), hay)


def test_count_parity_10k():
    rng = np.random.default_rng(7)
    needles = list(dict.fromkeys(
        "".join(chr(97 + c) for c in rng.integers(0, 26, size=rng.integers(5, 12)))
        for _ in range(3000)
    ))[:2500]
    corpus = synth_corpus(needles[:200], 1 << 21, hit_fraction=0.02, seed=11)
    got, want = _engines(needles)
    m = jac.build([(n, i) for i, n in enumerate(needles)])
    n = JaxCpp(m).count(np.frombuffer(corpus, np.uint8))
    for nt in (1, 4):  # one thread, and the threaded split
        assert got.count(corpus, n_threads=nt) == want.count(corpus, n_threads=nt) == n > 0
    assert got.first_hit(corpus) == want.first_hit(corpus) >= 0


def test_overlaps_and_duplicates():
    needles = ["aaaaa", "aaaaaa", "ababa", "ababa"]  # duplicate listed twice
    hay = b"aaaaaaaa abababa xx" * 50
    got, want = _engines(needles)
    assert got.count(hay) == want.count(hay) == _count(needles, hay)


def test_eligibility_gate():
    for needles in ([b"abcde", b"zzzzzz"], [b"abcd"], [], [b"abcde", b""]):
        assert prefilter.eligible(needles) is jprefilter.eligible(needles)
    assert prefilter.eligible([b"abcde", b"zzzzzz"])
    assert not prefilter.eligible([b"abcd"])  # 4 bytes
    assert not prefilter.eligible([])
    assert prefilter.MIN_PREFIX == jprefilter.MIN_PREFIX == 5
    w = np.random.default_rng(0).integers(0, 1 << 40, size=64).astype(np.uint64)
    np.testing.assert_array_equal(prefilter._mix5(w), jprefilter._mix5(w))
    with pytest.raises(ValueError, match=">= 5 bytes"):
        prefilter.PrefilterEngine(["abcd"])


def test_first_hit_and_tails():
    got, want = _engines(["qqqqq", "wwwww"])
    for hay, first in ((b"zzz qqqqq", 4), (b"zzzz", -1), (b"", -1)):
        assert got.first_hit(hay) == want.first_hit(hay) == first
    for hay, n in ((b"qqqq", 0), (b"", 0), (b"xxqqqqq", 1), (b"xxqqqq", 0)):
        # shorter than any needle, empty, a match at the very end, and a
        # needle tail that must not read past the corpus
        assert got.count(hay) == want.count(hay) == n


def test_binary_needles():
    needles = [b"\x00\x01\x02\x03\x04", b"\xff\xfe\xfd\xfc\xfb\xfa"]
    hay = b"\x00\x01\x02\x03\x04 junk \xff\xfe\xfd\xfc\xfb\xfa" * 20
    got, want = _engines(needles)
    assert got.count(hay) == want.count(hay) == _count(needles, hay) == 40


def test_never_on_composed_ci_machine(monkeypatch):
    """A composed case-folding machine carries ORIGINAL-case needles while
    its delta folds: byte-exact prefiltering would turn IGNORE_CASE into
    CaseSensitive results, so the composed engine refuses the prefilter.
    The CaseSensitive ``cpp`` backend takes it under ``AMT_PREFILTER=1`` and
    leaves it under ``AMT_PREFILTER=0``."""
    monkeypatch.setenv("AMT_PREFILTER", "1")
    monkeypatch.setattr(MatchEngine, "AUTO_COMPOSE_BYTES", 0)
    s = Searcher.build(IGNORE_CASE, ["tshirt", "kelvin"], engine="cpp", device="cpu")
    hay = "TSHIRT tshirt KELVIN kelvin " * 50
    want = jamt.Searcher.build(jamt.IGNORE_CASE, ["tshirt", "kelvin"], engine="cpp")
    assert s.count_matches(hay) == want.count_matches(hay) == 200
    assert s.contains_any("TSHIRT ONLY UPPER") is True
    ci = s._engine._composed(IGNORE_CASE)
    assert ci is not None and ci._prefilter() is None
    cs = Searcher.build(CASE_SENSITIVE, ["tshirt", "kelvin"], engine="cpp", device="cpu")
    assert isinstance(cs._engine._prefilter(), prefilter.PrefilterEngine)
    assert cs.count_matches(hay) == 100 and cs.contains_any(hay) is True
    monkeypatch.setenv("AMT_PREFILTER", "0")
    off = Searcher.build(CASE_SENSITIVE, ["tshirt", "kelvin"], engine="cpp", device="cpu")
    assert off._engine._prefilter() is None and off.count_matches(hay) == 100
