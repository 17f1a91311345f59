"""The generator: bytes drawn whole from the seed."""

import collections

import pytest

from perfbench.corpus import generate, stream_seed, to_host_bytes

NEEDLES = [b"tshirt", b"shirts", b"shorts"]


def _draw(seed, n=1 << 18, needles=NEEDLES):
    return to_host_bytes(generate(n, needles, seed, hit_fraction=0.01, word_min=3, word_max=9,
                                  device="cpu"))


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 17, 2**40 + 3])
def test_same_seed_same_bytes_other_seed_other_bytes(seed):
    a, b, c = _draw(seed), _draw(seed), _draw(seed + 1)
    assert len(a) == 1 << 18 and a == b and a != c


def test_words_letters_and_needles():
    data = _draw(3, 1 << 20)
    assert set(data) <= set(b"abcdefghijklmnopqrstuvwxyz ")
    words = data.split(b" ")[:-1]  # the last word may be cut at the end
    assert not [w for w in words if not 3 <= len(w) <= 9]
    share = sum(w in NEEDLES for w in words) / len(words)
    assert 0.008 < share < 0.012
    lengths = collections.Counter(len(w) for w in words if w not in NEEDLES)
    assert set(lengths) == set(range(3, 10))


def test_needles_of_any_length_and_no_repeated_block():
    needles = [b"abc", b"abcd", b"bcd", b"c", b"zuusqi"]
    data = _draw(5, 1 << 20, needles)
    words = data.split(b" ")[:-1]
    assert {w for w in words if len(w) < 3} == {b"c"}
    # No block of the text comes back: 256 bytes from the middle occur once.
    probe = data[len(data) // 2 : len(data) // 2 + 256]
    assert data.count(probe) == 1


def test_stream_seeds_differ_by_document_and_fit_63_bits():
    seeds = {stream_seed(s, i) for s in (1, 2**31 + 5) for i in range(8)}
    assert len(seeds) == 16 and all(0 <= s < 2**63 for s in seeds)
