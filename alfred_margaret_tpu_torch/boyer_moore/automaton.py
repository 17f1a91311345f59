"""Single-needle case-sensitive Boyer-Moore matching.

Mirrors ``Data.Text.BoyerMoore.Automaton`` (``BoyerMoore/Automaton.hs``):
byte-level matching with bad-character and good-suffix skip tables, reporting
**non-overlapping** matches by their *start* byte index (unlike Aho-Corasick,
which reports one-past-end — ``BoyerMoore/Automaton.hs:103-106``). An empty
pattern never matches.

The skip tables are built exactly like the classic algorithm the reference
translates (``BoyerMoore/Automaton.hs:186-340``) and validated by property
tests; the default ``run_text`` hot path uses ``bytes.find`` (C speed, same
non-overlapping leftmost match set) while ``run_text_classic`` drives the
genuine skip-table loop for conformance. Device-side batch matching of single
needles goes through the AC engine (the reference itself establishes
BM == single-needle-AC equivalence, ``tests/.../BoyerMooreSpec.hs:187-199``).

The port's copy of ``alfred_margaret_tpu/boyer_moore/automaton.py``, host
only; ``tests/test_torch_boyer_moore.py`` holds it against the original.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, NamedTuple, Union

import numpy as np

from ..models.ac import Done, Step
from ..utils import utf8


@dataclass
class Automaton:
    pattern: bytes
    suffix_table: np.ndarray  # int32 [pat_len] good-suffix skips
    bad_char_table: np.ndarray  # int32 [256] bad-character skips

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Automaton) and self.pattern == other.pattern

    def __hash__(self) -> int:
        return hash(self.pattern)

    def __repr__(self) -> str:
        return f"build_automaton({self.pattern!r})"

    def to_json(self) -> str:
        import json

        return json.dumps(self.pattern.decode("utf-8"))

    @classmethod
    def from_json(cls, blob: str) -> "Automaton":
        import json

        return build_automaton(json.loads(blob))


def _is_prefix(pattern: bytes, pos: int) -> bool:
    """Is pattern[pos:] a prefix of pattern? (``BoyerMoore/Automaton.hs:265-275``)"""
    suffix_len = len(pattern) - pos
    return pattern[:suffix_len] == pattern[pos : pos + suffix_len]


def _suffix_length(pattern: bytes, pos: int) -> int:
    """Length of the longest common suffix of pattern[:pos+1] and pattern
    (``BoyerMoore/Automaton.hs:280-286``)."""
    m = len(pattern)
    k = 0
    while k <= pos and pattern[pos - k] == pattern[m - 1 - k]:
        k += 1
    return k


def build_suffix_table(pattern: bytes) -> np.ndarray:
    """Good-suffix shift table (``buildSuffixTable``,
    ``BoyerMoore/Automaton.hs:186-236`` — the classic two-pass algorithm)."""
    m = len(pattern)
    table = np.zeros(m, dtype=np.int32)
    last_prefix_index = m
    for p in range(m - 1, -1, -1):
        if _is_prefix(pattern, p + 1):
            last_prefix_index = p + 1
        table[p] = last_prefix_index + (m - 1 - p)
    for p in range(m - 1):
        slen = _suffix_length(pattern, p)
        if p - slen < 0 or pattern[p - slen] != pattern[m - 1 - slen]:
            table[m - 1 - slen] = m - 1 - p + slen
    return table


def build_bad_char_table(pattern: bytes) -> np.ndarray:
    """Bad-character table: dense 256-entry byte table of skip distances,
    rightmost occurrence excluding the last pattern byte
    (``BoyerMoore/Automaton.hs:242-340``)."""
    m = len(pattern)
    table = np.full(256, m, dtype=np.int32)
    for i, b in enumerate(pattern[:-1]):
        table[b] = m - 1 - i
    return table


def build_automaton(pattern: utf8.TextLike) -> Automaton:
    pattern = utf8.to_bytes(pattern)
    return Automaton(
        pattern=pattern,
        suffix_table=build_suffix_table(pattern),
        bad_char_table=build_bad_char_table(pattern),
    )


def pattern_length(automaton: Automaton) -> int:
    """Pattern length in UTF-8 code units (bytes)."""
    return len(automaton.pattern)


def pattern_text(automaton: Automaton) -> bytes:
    return automaton.pattern


def run_text(seed: Any, f: Callable[[Any, int], Any], automaton: Automaton, text: utf8.TextLike) -> Any:
    """Fold ``f`` over non-overlapping match *start* indices, left to right;
    ``f`` returns Step/Done (``runText``, ``BoyerMoore/Automaton.hs:116-165``).

    Uses ``bytes.find`` for the scan: the match set (leftmost,
    non-overlapping) is identical to the skip-table loop, at C speed.
    """
    pattern = automaton.pattern
    if len(pattern) == 0:
        return seed
    data = utf8.to_bytes(text)
    start = 0
    while True:
        i = data.find(pattern, start)
        if i < 0:
            return seed
        nxt = f(seed, i)
        if isinstance(nxt, Done):
            return nxt.acc
        seed = nxt.acc if isinstance(nxt, Step) else nxt
        start = i + len(pattern)


def run_text_classic(
    seed: Any, f: Callable[[Any, int], Any], automaton: Automaton, text: utf8.TextLike
) -> Any:
    """The genuine Boyer-Moore loop with skip tables, mirroring the
    reference's hot loop shape (``BoyerMoore/Automaton.hs:116-165``);
    used to validate the tables and the fast path against each other."""
    pattern = automaton.pattern
    pat_len = len(pattern)
    if pat_len == 0:
        return seed
    data = utf8.to_bytes(text)
    n = len(data)
    bad_char = automaton.bad_char_table
    suffix = automaton.suffix_table
    i = pat_len - 1  # haystack index aligned at pattern end
    while i < n:
        j = pat_len - 1
        while j >= 0 and data[i] == pattern[j]:
            i -= 1
            j -= 1
        if j < 0:
            nxt = f(seed, i + 1)
            if isinstance(nxt, Done):
                return nxt.acc
            seed = nxt.acc if isinstance(nxt, Step) else nxt
            # i points one byte before the match; skip two pattern lengths to
            # land one past the non-overlapping region (Automaton.hs:145-152).
            i += 2 * pat_len
        else:
            i += max(int(bad_char[data[i]]), int(suffix[j]))
    return seed


def matches(automaton: Automaton, text: utf8.TextLike) -> List[int]:
    """All non-overlapping match start indices (``run_text`` already scans
    via ``bytes.find`` at C speed)."""
    out: List[int] = []

    def fold(acc, pos):
        acc.append(pos)
        return Step(acc)

    return run_text(out, fold, automaton, text)


__all__ = [
    "Automaton",
    "build_automaton",
    "build_suffix_table",
    "build_bad_char_table",
    "pattern_length",
    "pattern_text",
    "run_text",
    "run_text_classic",
    "matches",
]
