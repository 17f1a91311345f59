"""Single-needle case-insensitive replace-all with an output length cap.

Mirrors ``Data.Text.BoyerMooreCI.Replacer.replaceSingleLimited``
(``BoyerMooreCI/Replacer.hs:28-82``): non-overlapping leftmost replacement
on the lowered haystack with raw-coordinate splicing; the match end reported
by the automaton is inclusive, so splices run to ``match_end + 1``
(``BoyerMooreCI/Replacer.hs:62``).
"""

from __future__ import annotations

from typing import Any, Optional

from ..utils import utf8
from . import automaton as bmci

MAX_BOUND = 2**63 - 1


def replace_single_limited(
    needle: bmci.Automaton,
    replacement: utf8.TextLike,
    haystack: utf8.TextLike,
    max_length: int = MAX_BOUND,
) -> Optional[Any]:
    as_str = isinstance(haystack, str)
    repl = utf8.to_bytes(replacement)
    data = utf8.to_bytes(haystack)

    if bmci.pattern_length(needle) == 0:
        # The reference does not apply the length cap on this branch.
        result = repl if len(data) == 0 else data
        return result.decode("utf-8") if as_str else result

    chunks = []
    prev_end = 0
    length = 0
    for match_start, match_end in bmci.matches(needle, data):
        part = data[prev_end:match_start]
        chunks.append(part)
        chunks.append(repl)
        length += len(part) + len(repl)
        prev_end = match_end + 1
        if length > max_length:
            return None
    tail = data[prev_end:]
    if length + len(tail) > max_length:
        return None
    chunks.append(tail)
    result = b"".join(chunks)
    return result.decode("utf-8") if as_str else result


__all__ = ["replace_single_limited", "MAX_BOUND"]
