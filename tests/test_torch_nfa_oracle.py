"""The port's independent NFA oracle (``models/nfa_oracle.py``) against the
JAX package's and the automaton.

Mirrors ``tests/test_nfa_oracle.py``: the oracle shares no construction code
with ``models.ac``, so a construction bug that every table-executing engine (the
host C++ engine, the kernels) reproduces identically is still caught.  Each
answer of the port's oracle equals the JAX oracle's and the port's
automaton's.  Tolerance: exact equality.
"""

import numpy as np
import pytest

from alfred_margaret_tpu.models import nfa_oracle as jnfa

from alfred_margaret_tpu_torch.bench.dataformat import synth_corpus
from alfred_margaret_tpu_torch.models import ac, nfa_oracle
from alfred_margaret_tpu_torch.models.nfa_oracle import NfaOracle, cross_check_counts
from alfred_margaret_tpu_torch.native.cpp_engine import CppAcEngine

CASES = [
    ["tshirt", "shirts", "shorts"],
    ["abc", "abcd", "bcd", "c", "bc"],
    ["a", "aa", "aaa"],  # heavy overlap / suffix chains
    ["ab", "ba"],  # alternation
    ["İstanbul".encode(), "ß".encode(), b"\xff\xfe"],  # non-ASCII bytes
]


def _build(needles):
    return ac.build([(n, i) for i, n in enumerate(needles)])


@pytest.mark.parametrize("needles", CASES, ids=[str(i) for i in range(len(CASES))])
def test_match_parity(needles):
    m = _build(needles)
    oracle = NfaOracle(needles)
    if any(isinstance(n, bytes) for n in needles):
        rng = np.random.default_rng(13)
        nb = [n if isinstance(n, bytes) else n.encode() for n in needles]
        parts = [bytes(rng.integers(0, 256, size=7, dtype=np.uint8)) for _ in range(40)]
        corpus = b"".join(p + nb[i % len(nb)] for i, p in enumerate(parts))
    else:
        corpus = synth_corpus(needles, 1 << 14, hit_fraction=0.08, seed=13)
    want = [(x.pos, x.value) for x in ac.all_matches(m, corpus)]
    got = oracle.all_matches(corpus)
    assert got == want == jnfa.NfaOracle(needles).all_matches(corpus)
    assert oracle.count(corpus) == len(want) == jnfa.NfaOracle(needles).count(corpus)
    assert oracle.contains_any(corpus) is jnfa.NfaOracle(needles).contains_any(corpus)


def test_count_parity_random_pool():
    rng = np.random.default_rng(5)
    for _ in range(8):
        frags = ["".join(chr(97 + c) for c in rng.integers(0, 4, size=rng.integers(1, 4)))
                 for _ in range(6)]
        needles = list(dict.fromkeys("".join(rng.choice(frags, size=rng.integers(1, 3)))
                                     for _ in range(10)))
        hay = "".join(rng.choice(frags, size=200))
        want = ac.count_matches(_build(needles), hay)
        assert NfaOracle(needles).count(hay) == jnfa.NfaOracle(needles).count(hay) == want


def test_empty_needle_piggyback_quirk():
    # The reference leaks the empty needle's value into every non-root
    # state's flattened output set (Automaton.hs:367-380); the engines
    # reproduce it and the oracle must agree.
    needles = ["", "ab"]
    oracle = NfaOracle(needles)
    m = _build(needles)
    for hay in ("abab", "xx", "aXab", "bbb"):
        want = [(x.pos, x.value) for x in ac.all_matches(m, hay)]
        assert oracle.all_matches(hay) == want == jnfa.NfaOracle(needles).all_matches(hay), hay
        assert oracle.count(hay) == len(want)
    assert oracle.all_matches("xx") == []
    assert oracle.count("abab") == 6  # 'a': empty, 'ab': ab + empty, twice
    # Two empty needles: later-inserted payload first (insertWith (++)).
    m2 = ac.build([("", 0), ("a", 1), ("", 2)])
    want2 = [(x.pos, x.value) for x in ac.all_matches(m2, "za")]
    assert NfaOracle(["", "a", ""]).all_matches("za") == want2 == [(2, 1), (2, 2), (2, 0)]
    # Mid-code-point suppression: the empty value fires once per code point.
    m3 = ac.build([("", 0), ("é", 1)])
    want3 = [(x.pos, x.value) for x in ac.all_matches(m3, "éé")]
    assert NfaOracle(["", "é"]).all_matches("éé") == want3


def test_contains_any():
    oracle = NfaOracle(["abc"])
    assert oracle.contains_any("zzabczz") is True
    assert oracle.contains_any("zzabzz") is False
    assert NfaOracle(["", "x"]).contains_any("y") is jnfa.NfaOracle(["", "x"]).contains_any("y")


def test_cross_check_helpers():
    needles = ["ab", "bc"]
    m = _build(needles)
    cross_check_counts(needles, "xabcx", ac.count_matches(m, "xabcx"))
    with pytest.raises(AssertionError):
        cross_check_counts(needles, "xabcx", 99)
    ends, vids = CppAcEngine(m).matches_arrays(b"xabcx" * 3)
    nfa_oracle.cross_check_matches(needles, b"xabcx" * 3, ends, vids)
    with pytest.raises(AssertionError, match="first divergence at index 0"):
        nfa_oracle.cross_check_matches(needles, b"xabcx" * 3, ends, vids[::-1])
    assert nfa_oracle.__all__ == jnfa.__all__


def test_mutation_caught_by_oracle_not_by_cpp():
    """Seed a construction bug into the built tables: the port's host C++
    engine reproduces it bit for bit, the independent NFA does not."""
    needles = ["abc", "abcd", "bcd"]
    m = _build(needles)
    corpus = b"zabcdz" * 50
    good = ac.count_matches(m, corpus)
    s = 0
    for b in b"abc":
        s = int(m.delta[s, b])
    mutated = m.delta.copy()
    assert mutated[s, ord("d")] != 0
    mutated[s, ord("d")] = 0  # the failure-resolved transition dropped
    m_bug = ac.AcMachine(delta=mutated, out_offset=m.out_offset, out_values=m.out_values,
                         match_count=m.match_count, values=m.values, needles=m.needles,
                         max_needle_bytes=m.max_needle_bytes, fail=m.fail)
    bad = ac.count_matches(m_bug, corpus)
    assert bad != good
    assert CppAcEngine(m_bug).count(np.frombuffer(corpus, np.uint8)) == bad
    with pytest.raises(AssertionError):
        cross_check_counts(needles, corpus, bad)
    cross_check_counts(needles, corpus, good)
