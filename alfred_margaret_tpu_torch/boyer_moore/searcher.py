"""Multi-needle facade over independent Boyer-Moore automata.

Mirrors ``Data.Text.BoyerMoore.Searcher`` (``BoyerMoore/Searcher.hs:50-121``):
a searcher is a *list* of single-needle automata, one scan per needle. For
large haystacks we route ``contains_any``/``contains_all`` through the AC
dense-DFA engine instead (single pass over the haystack for all needles) —
the match-existence semantics are identical; empty needles never match.

The port's copy of ``alfred_margaret_tpu/boyer_moore/searcher.py``.  The
Boyer-Moore scans run on the host; the AC route is the port's ``Searcher`` on
``device`` (``"cuda"`` unless the caller asks for ``"cpu"``), so under
``engine="auto"`` a large haystack rides the device kernels, as the
reference's ``MatchEngine`` sends it to its Pallas kernels.
"""

from __future__ import annotations

from typing import Any, Iterable, List, Tuple

from ..utils import utf8
from ..utils.device import resolve_device
from ..utils.case import CASE_SENSITIVE
from . import automaton as bm

#: Above this many haystack bytes, existence queries use the AC engine.
AC_ROUTE_THRESHOLD = 1 << 16


class Searcher:
    def __init__(self, needles_with_values: List[Tuple[bytes, Any]], engine: str = "auto", *,
                 device="cuda"):
        resolve_device(device)
        self._device = device
        self._needles = needles_with_values
        self._automata = [(bm.build_automaton(n), v) for n, v in needles_with_values]
        self._engine_name = engine
        self._ac = None

    @classmethod
    def build(cls, needles: Iterable[utf8.TextLike], engine: str = "auto", *,
              device="cuda") -> "Searcher":
        return cls([(utf8.to_bytes(n), ()) for n in needles], engine=engine, device=device)

    @classmethod
    def build_with_values(
        cls, needles_with_values: Iterable[Tuple[utf8.TextLike, Any]], engine: str = "auto", *,
        device="cuda",
    ) -> "Searcher":
        return cls([(utf8.to_bytes(n), v) for n, v in needles_with_values], engine=engine,
                   device=device)

    @classmethod
    def build_needle_id_searcher(cls, needles: Iterable[utf8.TextLike], engine: str = "auto", *,
                                 device="cuda") -> "Searcher":
        return cls([(utf8.to_bytes(n), i) for i, n in enumerate(needles)], engine=engine,
                   device=device)

    @property
    def needles(self) -> List[Tuple[bytes, Any]]:
        return list(self._needles)

    @property
    def num_needles(self) -> int:
        return len(self._needles)

    @property
    def automata(self) -> List[Tuple[bm.Automaton, Any]]:
        return list(self._automata)

    def _key(self):
        return tuple((n, v) for n, v in self._needles)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Searcher) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def _ac_searcher(self):
        if self._ac is None:
            from ..searcher import Searcher as AcSearcher

            self._ac = AcSearcher.build_needle_id_searcher(
                CASE_SENSITIVE,
                [n for n, _ in self._needles],
                engine=self._engine_name,
                device=self._device,
            )
        return self._ac

    def contains_any(self, haystack: utf8.TextLike) -> bool:
        """Any needle occurs (``containsAny``, ``BoyerMoore/Searcher.hs:98-105``).
        Note: empty needles never match (unlike ``isInfixOf "")``)."""
        data = utf8.to_bytes(haystack)
        if len(data) > AC_ROUTE_THRESHOLD and self.num_needles > 1:
            return self._ac_searcher().contains_any(data)
        return any(data.find(a.pattern) >= 0 and len(a.pattern) > 0 for a, _ in self._automata)

    def contains_all(self, haystack: utf8.TextLike) -> bool:
        """All needles occur (``containsAll``, ``BoyerMoore/Searcher.hs:114-121``)."""
        data = utf8.to_bytes(haystack)
        if len(data) > AC_ROUTE_THRESHOLD and self.num_needles > 1:
            return self._ac_searcher().contains_all(data)
        return all(len(a.pattern) > 0 and data.find(a.pattern) >= 0 for a, _ in self._automata)


__all__ = ["Searcher"]
