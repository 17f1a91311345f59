"""``Searcher`` on the port's engine.

Counterpart of ``alfred_margaret_tpu/searcher.py:Searcher``: a needle list
with values, the automaton built from it and the port's ``MatchEngine`` on a
device (``"cuda"`` unless the caller asks for ``"cpu"``).  Equality, hashing
and ``to_json`` are defined by the needle list only, as in the JAX package.
``build``, ``build_with_values``, ``save_npz``, ``load_npz``,
``set_case_sensitivity``, ``stage``, ``count_matches``, ``contains_any``,
``contains_all``, ``all_matches`` and ``all_matches_arrays`` work, in both
case modes, on whichever engine ``MatchEngine`` picks for the needle set
(the needle-grouped one for sets that no single-pass engine holds; for
IgnoreCase the composed case DFA or the lowering path).  Every other
operation raises ``NotImplementedError`` naming the ROADMAP item that brings
it.

As in the reference, an ``IGNORE_CASE`` searcher expects lowercase needles:
uppercase needles never match (``Searcher.hs:108-118``).
"""

from __future__ import annotations

import json
from typing import Any, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .engine import MatchEngine
from .models import ac
from .utils import utf8
from .utils.case import CaseSensitivity


def _todo(what: str, item: str):
    def method(self, *args, **kwargs):
        raise NotImplementedError(f"{what} is not ported yet: ROADMAP Queue A item {item}")

    method.__name__ = what
    return method


def _hashable(v: Any):
    if isinstance(v, (list, np.ndarray)):
        return tuple(v)
    return v


class Searcher:
    """A set of needles with values, matched by the port's kernels.

    INVARIANT: the automaton is always ``ac.build(needles)``."""

    def __init__(
        self,
        case: CaseSensitivity,
        needles_with_values: Sequence[Tuple[bytes, Any]],
        machine: Optional[ac.AcMachine] = None,
        engine: str = "auto",
        *,
        device="cuda",
    ):
        self._case = case
        self._needles: List[Tuple[bytes, Any]] = [
            (utf8.to_bytes(n), v) for n, v in needles_with_values
        ]
        self._machine = machine if machine is not None else ac.build(self._needles)
        self._engine_name = engine
        self._engine = MatchEngine(self._machine, engine, device=device)

    @classmethod
    def build(
        cls, case: CaseSensitivity, needles: Iterable[utf8.TextLike], engine: str = "auto", *,
        device="cuda",
    ) -> "Searcher":
        return cls(case, [(utf8.to_bytes(n), ()) for n in needles], engine=engine, device=device)

    @classmethod
    def build_with_values(
        cls,
        case: CaseSensitivity,
        needles_with_values: Iterable[Tuple[utf8.TextLike, Any]],
        engine: str = "auto",
        *,
        device="cuda",
    ) -> "Searcher":
        return cls(
            case, [(utf8.to_bytes(n), v) for n, v in needles_with_values],
            engine=engine, device=device,
        )

    # -- accessors -----------------------------------------------------------

    @property
    def needles(self) -> List[Tuple[bytes, Any]]:
        return list(self._needles)

    @property
    def num_needles(self) -> int:
        return len(self._needles)

    @property
    def case_sensitivity(self) -> CaseSensitivity:
        return self._case

    @property
    def automaton(self) -> ac.AcMachine:
        return self._machine

    @property
    def device(self):
        return self._engine.device

    def set_case_sensitivity(self, case: CaseSensitivity) -> "Searcher":
        """Switch case mode without re-capitalizing needles; with IGNORE_CASE
        the caller must be sure the needles are lowercase already
        (``Searcher.hs:139-145``)."""
        return Searcher(case, self._needles, machine=self._machine, engine=self._engine_name,
                        device=self.device)

    # -- equality, hashing and serialization by needles ------------------------

    def _key(self):
        return (self._case, tuple((n, _hashable(v)) for n, v in self._needles))

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Searcher) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return f"Searcher({self._case}, {self.num_needles} needles)"

    def to_json(self) -> str:
        return json.dumps(
            {
                "caseSensitivity": self._case.to_json(),
                "needles": [[n.decode("utf-8"), v] for n, v in self._needles],
            }
        )

    # -- packed-table cold-start artifact -------------------------------------

    def save_npz(self, path: str) -> None:
        """Persist the built tables (no automaton rebuild on load, unlike the
        JSON-by-needles form).  Values must be in the typed-JSON codec's
        closed set (scalars, bytes, containers)."""
        ac.save_npz(self._machine, path, extra={"caseSensitivity": self._case.to_json()})

    @classmethod
    def load_npz(cls, path: str, engine: str = "auto", *, device="cuda") -> "Searcher":
        machine, extra = ac.load_npz(path, with_extra=True)
        case = CaseSensitivity.from_json(extra["caseSensitivity"])
        return cls(case, list(zip(machine.needles, machine.values)), machine=machine,
                   engine=engine, device=device)

    # -- matching ------------------------------------------------------------

    def stage(self, haystack: utf8.TextLike):
        """Prepare a haystack for repeated scans (device staging done once);
        pass the result to any matching operation."""
        return self._engine.stage(haystack, self._case)

    def contains_any(self, haystack: utf8.TextLike) -> bool:
        """True iff any needle occurs."""
        return self._engine.contains_any(haystack, self._case)

    def contains_all(self, haystack: utf8.TextLike) -> bool:
        """True iff every value has a match (every needle occurs, for
        needle-id values)."""
        if self.num_needles == 0:
            return True
        return bool(self._engine.value_presence(haystack, self._case).all())

    def count_matches(self, haystack: utf8.TextLike) -> int:
        return self._engine.count(haystack, self._case)

    def all_matches(self, haystack: utf8.TextLike) -> List[ac.Match]:
        """A list of ``Match(pos, value)``; bulk consumers prefer
        :meth:`all_matches_arrays`."""
        ms = self._engine.matches(haystack, self._case)
        values = self._machine.values
        return list(
            map(ac.Match, ms.ends.tolist(), map(values.__getitem__, ms.value_ids.tolist()))
        )

    def all_matches_arrays(self, haystack: utf8.TextLike):
        """(ends, value_ids) numpy arrays in emission order (``ends`` are
        byte positions one past each match; ``value_ids`` index
        :attr:`automaton` ``.values``)."""
        ms = self._engine.matches(haystack, self._case)
        return ms.ends, ms.value_ids

    build_needle_id_searcher = classmethod(_todo("build_needle_id_searcher", "8"))
    from_json = classmethod(_todo("from_json", "8"))
    map_searcher = _todo("map_searcher", "8")
    __add__ = _todo("__add__", "8")
    adopt_staged = _todo("adopt_staged", "8")
    distributed = _todo("distributed", "16")


__all__ = ["Searcher"]
