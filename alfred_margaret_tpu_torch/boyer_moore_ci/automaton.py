"""Single-needle case-insensitive Boyer-Moore matching.

Mirrors ``Data.Text.BoyerMooreCI.Automaton`` (``BoyerMooreCI/Automaton.hs``):
the pattern is stored as a code point sequence (expected lowercase — an
uppercase needle never matches, since only the *haystack* is lowered); the
haystack is lowered per code point on the fly; matches are non-overlapping
and reported as **(first byte, last byte)** indices, both inclusive, in raw
haystack coordinates (``BoyerMooreCI/Automaton.hs:119-126``).

Two interchangeable scan engines:

* ``run_text`` (default): lowers the haystack up front with the vectorized
  transducer (raw-coordinate maps included) and scans the lowered stream —
  the non-overlapping leftmost match set is identical, per the same argument
  the reference's own test suite uses (``BoyerMooreCISpec.hs:152-164``
  proves BMCI == AC-IgnoreCase-single-needle).  This is the fast path on
  vector hardware.
* ``run_text_classic``: the reference's genuine backwards skip-table scan —
  suffix table in BYTES indexed by pattern code-point position
  (``buildSuffixTable``, ``BoyerMooreCI/Automaton.hs:281-340``), bad-char
  lookup as a dense 256-entry table with a dict spill for cp >= 256
  (``buildBadCharLookup``, ``:390-477``), and the
  alignPattern/matchLoop walk with on-the-fly lowering and sub-linear
  byte skips (``runText``, ``:121-220``).  Kept as the scalar/host engine
  and as executable documentation of the reference algorithm; both engines
  are property-tested equal.

The port's copy of ``alfred_margaret_tpu/boyer_moore_ci/automaton.py``, host
only; ``tests/test_torch_boyer_moore.py`` holds it against the original.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, Tuple

import numpy as np

from ..models.ac import Done, Step
from ..utils import utf8


@dataclass
class Automaton:
    pattern_cps: Tuple[int, ...]  # code points, as given (expected lowercase)
    pattern_bytes: bytes  # utf-8 encoding of pattern_cps
    min_pattern_skip: int

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Automaton) and self.pattern_cps == other.pattern_cps

    def __hash__(self) -> int:
        return hash(self.pattern_cps)

    def __repr__(self) -> str:
        return f"build_automaton({self.pattern_bytes!r})"

    def to_json(self) -> str:
        import json

        return json.dumps(self.pattern_bytes.decode("utf-8"))

    @classmethod
    def from_json(cls, blob: str) -> "Automaton":
        import json

        return build_automaton(json.loads(blob))


def minimum_skip_for_code_point(cp: int) -> int:
    """Safe byte-skip for one pattern code point: the minimum UTF-8 byte
    length over all haystack case variants that lower to it
    (``BoyerMooreCI/Automaton.hs:231-253``; e.g. ⱥ is 3 bytes but its
    unlowering Ⱥ is 2, so the safe skip is 2).
    """
    variants = utf8.unlower_code_point(chr(cp))
    if not variants:
        # Uppercase input: undefined behaviour in the reference, which falls
        # back to the code point's own length.
        return utf8.num_code_units(cp)
    return min(utf8.num_code_units(ord(u)) for u in variants)


def minimum_skip_for_pattern(cps: Tuple[int, ...]) -> int:
    """Byte length of the shortest case variation of the needle
    (``minimumSkipForVector``, ``BoyerMooreCI/Automaton.hs:256-263``)."""
    return sum(minimum_skip_for_code_point(cp) for cp in cps)


def build_automaton(pattern: utf8.TextLike) -> Automaton:
    pattern_bytes = utf8.to_bytes(pattern)
    cps = tuple(ord(c) for c in pattern_bytes.decode("utf-8"))
    return Automaton(
        pattern_cps=cps,
        pattern_bytes=pattern_bytes,
        min_pattern_skip=minimum_skip_for_pattern(cps),
    )


def pattern_length(automaton: Automaton) -> int:
    """Pattern length in UTF-8 code units (bytes)."""
    return len(automaton.pattern_bytes)


def pattern_text(automaton: Automaton) -> bytes:
    return automaton.pattern_bytes


def run_text(
    seed: Any,
    f: Callable[[Any, int, int], Any],
    automaton: Automaton,
    text: utf8.TextLike,
) -> Any:
    """Fold ``f(acc, first_byte, last_byte)`` over non-overlapping matches,
    left to right; both indices inclusive, raw coordinates
    (``runText``, ``BoyerMooreCI/Automaton.hs:121-220``)."""
    if len(automaton.pattern_cps) == 0:
        return seed
    lt = utf8.lower_transform(text)
    lowered = lt.lowered.tobytes()
    pat = automaton.pattern_bytes
    pat_cp_len = len(automaton.pattern_cps)
    start = 0
    while True:
        i = lowered.find(pat, start)
        if i < 0:
            return seed
        # Only accept matches aligned to code point boundaries of the lowered
        # stream that span whole code points (a lowercase pattern always
        # aligns, but an arbitrary byte pattern might not).
        first_cp = int(lt.cp_index[i])
        last_cp = int(lt.cp_index[i + len(pat) - 1])
        if (
            int(lt.cp_index[i - 1]) != first_cp if i > 0 else True
        ) and last_cp - first_cp + 1 == pat_cp_len:
            raw_from = int(lt.raw_start[first_cp])
            raw_to = int(lt.raw_end[last_cp]) - 1
            nxt = f(seed, raw_from, raw_to)
            if isinstance(nxt, Done):
                return nxt.acc
            seed = nxt.acc if isinstance(nxt, Step) else nxt
            start = i + len(pat)  # non-overlapping
        else:
            start = i + 1


def matches(automaton: Automaton, text: utf8.TextLike) -> List[Tuple[int, int]]:
    """All non-overlapping (first_byte, last_byte) matches."""
    out: List[Tuple[int, int]] = []

    def fold(acc, frm, to):
        acc.append((frm, to))
        return Step(acc)

    return run_text(out, fold, automaton, text)


__all__ = [
    "Automaton",
    "build_automaton",
    "minimum_skip_for_code_point",
    "minimum_skip_for_pattern",
    "pattern_length",
    "pattern_text",
    "run_text",
    "matches",
]


# ---------------------------------------------------------------------------
# Classic backwards skip-table scan (the reference's genuine machinery)
# ---------------------------------------------------------------------------


def _suffix_is_prefix(cps: Tuple[int, ...], pos: int):
    """Byte length (in minimum-skip units) of the prefix equal to the suffix
    starting at ``pos``, or None (``suffixIsPrefix``,
    ``BoyerMooreCI/Automaton.hs:344-354``)."""
    suffix_len = len(cps) - pos
    skip = 0
    for i in range(suffix_len):
        if cps[i] != cps[pos + i]:
            return None
        skip += minimum_skip_for_code_point(cps[i])
    return skip


def _substring_is_suffix(cps: Tuple[int, ...], pos: int):
    """Length (code points) of the longest proper pattern suffix ending at
    ``pos``, or None (``substringIsSuffix``, ``:376-384``)."""
    n = len(cps)
    i = 0
    while True:
        if i > pos:
            return None  # prefix==suffix: covered by _suffix_is_prefix
        if cps[pos - i] == cps[n - 1 - i]:
            i += 1
            continue
        return None if i == 0 else i


def build_suffix_table(cps: Tuple[int, ...]) -> List[int]:
    """Good-suffix shifts in BYTES, indexed by pattern code-point position
    (``buildSuffixTable``, ``BoyerMooreCI/Automaton.hs:281-340``): case 1
    aligns the pattern on its longest suffix==prefix; case 2 overwrites with
    the smaller shifts for interior re-occurrences of matched suffixes; the
    last position always shifts by 1."""
    n = len(cps)
    whole = minimum_skip_for_pattern(cps)
    table = [0] * n
    # Case 1 (init1): right-to-left, carrying the last seen skip.
    last = whole - 1
    for p in range(n - 1, -1, -1):
        sp = _suffix_is_prefix(cps, p + 1)
        if sp is not None:
            last = whole - sp
        table[p] = last
    # Case 2 (init2): left-to-right, interior suffix re-occurrences.
    skip = whole
    for p in range(0, n - 1):
        skip -= minimum_skip_for_code_point(cps[p])
        sl = _substring_is_suffix(cps, p)
        if sl is not None:
            table[n - 1 - sl] = skip
    table[n - 1] = 1
    return table


def build_bad_char(cps: Tuple[int, ...]):
    """(dense 256-entry byte-skip table, spill dict for cp >= 256, default):
    skip to align the rightmost pattern occurrence of a haystack code point,
    excluding the last pattern position (``buildBadCharLookup``,
    ``BoyerMooreCI/Automaton.hs:390-477``)."""
    default = minimum_skip_for_pattern(cps)
    table = [default] * 256
    spill: dict = {}
    skip = default
    for cp in cps[:-1]:  # the last pattern character doesn't count
        skip -= minimum_skip_for_code_point(cp)
        if cp < 256:
            table[cp] = skip
        else:
            spill[cp] = skip
    return table, spill, default


def _bad_char_lookup(bc, cp: int) -> int:
    table, spill, default = bc
    if cp < 256:
        return table[cp]
    return spill.get(cp, default)


def _cp_around(data: bytes, i: int) -> Tuple[int, int, int, bool]:
    """(start, end_exclusive, code point, valid) of the code point containing
    byte ``i`` under the framework's strict forward segmentation
    (``unsafeIndexAnywhereInCodePoint'``, ``Utf8.hs:397-424``; tolerant of
    arbitrary bytes — invalid bytes are isolated single-byte units, matching
    ``utf8.decode_strict``'s stream segmentation)."""
    L = i
    back = 0
    while L > 0 and back < 3 and utf8.is_trail_byte(data[L]):
        L -= 1
        back += 1
    k, cp, valid = utf8.decode_strict(data, L)
    if L + k > i:
        return L, L + k, cp, valid
    return i, i + 1, data[i], False


def _tables(automaton: Automaton):
    t = getattr(automaton, "_classic_tables", None)
    if t is None:
        t = (build_suffix_table(automaton.pattern_cps), build_bad_char(automaton.pattern_cps))
        object.__setattr__(automaton, "_classic_tables", t)
    return t


def run_text_classic(
    seed: Any,
    f: Callable[[Any, int, int], Any],
    automaton: Automaton,
    text: utf8.TextLike,
) -> Any:
    """The reference's backwards skip-table scan (``runText``,
    ``BoyerMooreCI/Automaton.hs:121-220``): align the pattern end, compare
    code points back-to-front lowering the haystack on the fly, and on
    mismatch jump by max(bad-char, good-suffix) bytes.  Fold semantics,
    emission positions and the non-overlap rule (haystackMin =
    alignmentEnd + 1) are identical to ``run_text``."""
    cps = automaton.pattern_cps
    if len(cps) == 0:
        return seed
    data = utf8.to_bytes(text)
    suffix_table, bc = _tables(automaton)
    min_skip = automaton.min_pattern_skip
    haystack_max = len(data) - 1
    haystack_min = 0
    alignment_end = min_skip - 1
    acc = seed
    while alignment_end <= haystack_max:
        start, end, cp, valid = _cp_around(data, alignment_end)
        alignment_end = end - 1  # end of char may differ from where we looked
        pattern_index = len(cps) - 1
        while True:
            low = ord(utf8.lower_code_point(chr(cp))) if valid else cp
            if low == cps[pattern_index]:
                if pattern_index == 0:
                    nxt = f(acc, start, alignment_end)
                    if isinstance(nxt, Done):
                        return nxt.acc
                    acc = nxt.acc if isinstance(nxt, Step) else nxt
                    haystack_min = alignment_end + 1  # disallow overlaps
                    alignment_end = alignment_end + min_skip
                    break
                if start - 1 < haystack_min:
                    # Alignment start ran past haystackMin (only with
                    # byte-shrinking case variants like Ⱥ/Ⱦ).
                    alignment_end = alignment_end + 1
                    break
                start, end, cp, valid = _cp_around(data, start - 1)
                pattern_index -= 1
            else:
                from_bad_char = (end - 1) + _bad_char_lookup(bc, low)
                from_suffix = alignment_end + suffix_table[pattern_index]
                alignment_end = max(from_bad_char, from_suffix)
                break
    return acc


def matches_classic(automaton: Automaton, text: utf8.TextLike) -> List[Tuple[int, int]]:
    """All non-overlapping (first_byte, last_byte) matches via the classic
    skip-table scan."""
    out: List[Tuple[int, int]] = []

    def fold(acc, frm, to):
        acc.append((frm, to))
        return Step(acc)

    return run_text_classic(out, fold, automaton, text)


__all__ += [
    "build_bad_char",
    "build_suffix_table",
    "matches_classic",
    "run_text_classic",
]
