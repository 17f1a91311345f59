"""Single-needle replace-all with an output length cap.

Mirrors ``Data.Text.BoyerMoore.Replacer.replaceSingleLimited``
(``BoyerMoore/Replacer.hs:28-84``): case-sensitive, non-overlapping leftmost
replacement; returns None when the result would exceed ``max_length`` bytes.
Empty-needle edge case: returns the replacement for an empty haystack, the
haystack unchanged otherwise (``BoyerMoore/Replacer.hs:35``).
"""

from __future__ import annotations

from typing import Any, Optional

from ..utils import utf8
from . import automaton as bm

MAX_BOUND = 2**63 - 1


def replace_single_limited(
    needle: bm.Automaton,
    replacement: utf8.TextLike,
    haystack: utf8.TextLike,
    max_length: int = MAX_BOUND,
) -> Optional[Any]:
    as_str = isinstance(haystack, str)
    repl = utf8.to_bytes(replacement)
    data = utf8.to_bytes(haystack)
    needle_length = bm.pattern_length(needle)

    if needle_length == 0:
        # The reference does not apply the length cap on this branch.
        result = repl if len(data) == 0 else data
        return result.decode("utf-8") if as_str else result

    chunks = []
    prev_end = 0
    length = 0
    for match_start in bm.matches(needle, data):
        part = data[prev_end:match_start]
        chunks.append(part)
        chunks.append(repl)
        length += len(part) + len(repl)
        prev_end = match_start + needle_length
        if length > max_length:
            return None
    tail = data[prev_end:]
    if length + len(tail) > max_length:
        return None
    chunks.append(tail)
    result = b"".join(chunks)
    return result.decode("utf-8") if as_str else result


__all__ = ["replace_single_limited", "MAX_BOUND"]
