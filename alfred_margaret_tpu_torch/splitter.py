"""Splitting haystacks on a single separator needle.

Mirrors ``Data.Text.AhoCorasick.Splitter`` (``Splitter.hs``): a splitter
holds exactly one needle; splitting on N separator occurrences yields N+1
fragments (always at least one). Overlapping separator matches are ignored
(``Splitter.hs:157-170``) — they can occur when the separator has a
non-empty prefix that is also a suffix. For ``split_ignore_case`` the
splitter must have been constructed with a lowercase needle.

The port's copy of ``alfred_margaret_tpu/splitter.py``: the separator's
matches come from the port's ``MatchEngine`` on ``device`` (``"cuda"``
unless the caller asks for ``"cpu"``); the fragments are cut on the host.
``tests/test_torch_splitter.py`` holds it against the JAX package's.
"""

from __future__ import annotations

from typing import Any, List

import numpy as np

from .engine import MatchEngine
from .models import ac
from .utils import utf8
from .utils.case import CASE_SENSITIVE, IGNORE_CASE, CaseSensitivity


class Splitter:
    def __init__(self, separator: utf8.TextLike, engine: str = "auto", *, device="cuda"):
        self._separator = utf8.to_bytes(separator)
        self._machine = ac.build([(self._separator, ())])
        self._engine = MatchEngine(self._machine, engine, device=device)

    @property
    def _separator_str(self) -> str:
        # Decoded lazily: only IGNORE_CASE splitting (code-point length) and
        # to_json need the str form, so byte separators that are not valid
        # UTF-8 still construct and split() case-sensitively.
        return self._separator.decode("utf-8")

    @classmethod
    def build(cls, separator: utf8.TextLike, engine: str = "auto", *,
              device="cuda") -> "Splitter":
        return cls(separator, engine=engine, device=device)

    @property
    def separator(self) -> bytes:
        return self._separator

    @property
    def automaton(self) -> ac.AcMachine:
        return self._machine

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Splitter) and self._separator == other._separator

    def __hash__(self) -> int:
        return hash(self._separator)

    def __repr__(self) -> str:
        return f"Splitter.build({self._separator!r})"

    def to_json(self) -> str:
        import json

        return json.dumps(self._separator_str)

    @classmethod
    def from_json(cls, blob: str, *, device="cuda") -> "Splitter":
        import json

        return cls(json.loads(blob), device=device)

    # -- splitting ---------------------------------------------------------

    def _split(self, haystack: utf8.TextLike, case: CaseSensitivity) -> List[Any]:
        as_str = isinstance(haystack, str)
        data = utf8.to_bytes(haystack)
        ms = self._engine.matches(data, case)
        if case is IGNORE_CASE:
            # Separator length counts code points (byte lengths of case
            # variants differ, Splitter.hs:111-121).
            lenc = len(self._separator_str)
            if len(ms.ends) == 0:
                sep_starts = np.zeros(0, dtype=np.int64)
            elif ms.lowered is None:
                # Composed case-DFA path: raw-coordinate ends, recover
                # starts by backward code-point skipping (Splitter.hs:111-121).
                sep_starts = utf8.raw_match_starts(data, ms.ends, lenc)
            else:
                lt = ms.lowered
                end_cp = lt.cp_of_raw_end(ms.ends)
                sep_starts = lt.raw_start_of_cp(end_cp - (lenc - 1))
        else:
            sep_starts = ms.ends - len(self._separator)

        fragments: List[bytes] = []
        frag_start = 0
        for sep_start, sep_end in zip(sep_starts, ms.ends):
            if sep_start < frag_start:
                continue  # overlapping separator match: ignore
            fragments.append(data[frag_start:sep_start])
            frag_start = int(sep_end)
        fragments.append(data[frag_start:])
        if as_str:
            return [f.decode("utf-8") for f in fragments]
        return fragments

    def split(self, haystack: utf8.TextLike) -> List[Any]:
        """Split on the separator, case-sensitively (``Splitter.hs:84-85``)."""
        return self._split(haystack, CASE_SENSITIVE)

    def split_ignore_case(self, haystack: utf8.TextLike) -> List[Any]:
        """Split on the separator case-insensitively; the separator must be
        lowercase (``Splitter.hs:90-96``)."""
        return self._split(haystack, IGNORE_CASE)

    def split_reverse(self, haystack: utf8.TextLike) -> List[Any]:
        """Fragments in reverse order (``splitReverse``, ``Splitter.hs:99-107``)."""
        return list(reversed(self.split(haystack)))

    def split_reverse_ignore_case(self, haystack: utf8.TextLike) -> List[Any]:
        return list(reversed(self.split_ignore_case(haystack)))


__all__ = ["Splitter"]
