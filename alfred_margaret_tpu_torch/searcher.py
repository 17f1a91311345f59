"""``Searcher`` on the port's engine.

Counterpart of ``alfred_margaret_tpu/searcher.py:Searcher``: a needle list
with values, the automaton built from it and the port's ``MatchEngine`` on a
device (``"cuda"`` unless the caller asks for ``"cpu"``).  Equality, hashing
and ``to_json`` are defined by the needle list only, as in the JAX package.
Every operation of the JAX ``Searcher`` works (``build``,
``build_with_values``, ``build_needle_id_searcher``, ``map_searcher``,
``+``, ``set_case_sensitivity``, ``to_json`` / ``from_json``, ``save_npz`` /
``load_npz``, ``stage``, ``adopt_staged``, ``count_matches``,
``contains_any``, ``contains_all``, ``all_matches``,
``all_matches_arrays``), in both case modes, on whichever engine
``MatchEngine`` picks for the needle set (the needle-grouped one for sets
that no single-pass engine holds; for IgnoreCase the composed case DFA or
the lowering path); ``distributed`` gives the sharded engine of
``parallel``.

As in the reference, an ``IGNORE_CASE`` searcher expects lowercase needles:
uppercase needles never match (``Searcher.hs:108-118``).
"""

from __future__ import annotations

import json
from typing import Any, Callable, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .engine import COMPOSED_CI_MAX_STATES, MatchEngine
from .models import ac, case_dfa
from .utils import trace, utf8
from .utils.case import IGNORE_CASE, CaseSensitivity


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

    @classmethod
    def build_needle_id_searcher(
        cls, case: CaseSensitivity, needles: Iterable[utf8.TextLike], engine: str = "auto", *,
        device="cuda",
    ) -> "Searcher":
        """Values are needle indices (for ``contains_all``, ``Searcher.hs:167-169``)."""
        return cls(case, [(utf8.to_bytes(n), i) for i, n in enumerate(needles)],
                   engine=engine, device=device)

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

    def map_searcher(self, f: Callable[[Any], Any]) -> "Searcher":
        """Map over the values (``mapSearcher``, ``Searcher.hs:121-125``); the
        automaton's tables are shared."""
        return Searcher(self._case, [(n, f(v)) for n, v in self._needles],
                        machine=self._machine.map_values(f), engine=self._engine_name,
                        device=self.device)

    def __add__(self, other: "Searcher") -> "Searcher":
        """The needles of both, this searcher's first (``Searcher.hs:100-105``);
        ``ValueError`` when the case modes differ."""
        if self._case != other._case:
            raise ValueError("Combining searchers of different case sensitivity")
        return Searcher(self._case, self._needles + other._needles, engine=self._engine_name,
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

    @classmethod
    def from_json(cls, blob: str, engine: str = "auto", *, device="cuda") -> "Searcher":
        """The searcher of ``to_json``'s needle list; the automaton is rebuilt."""
        obj = json.loads(blob)
        case = CaseSensitivity.from_json(obj["caseSensitivity"])
        pairs = [(n.encode("utf-8"), v) for n, v in obj["needles"]]
        return cls(case, pairs, engine=engine, device=device)

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
        with trace.span("amt.api.stage"):
            return self._engine.stage(haystack, self._case)

    def adopt_staged(self, staged):
        """Rebind ANOTHER searcher's staged haystack to this searcher, the
        needle-set swap of a server: the corpus's device streams and host
        lowering are reused where this searcher's warm-up overlap allows,
        and restaged from the staged bytes where it does not.  Raises
        ``ValueError`` when the staging kept only lowered bytes and this
        searcher needs raw ones (stage the raw text instead)."""
        with trace.span("amt.api.adopt_staged"):
            return self._engine.adopt_staged(staged, self._case)

    def contains_any(self, haystack: utf8.TextLike) -> bool:
        """True iff any needle occurs."""
        with trace.span("amt.api.contains_any"):
            return self._engine.contains_any(haystack, self._case)

    def contains_all(self, haystack: utf8.TextLike) -> bool:
        """True iff every value has a match (every needle occurs, for
        needle-id values)."""
        with trace.span("amt.api.contains_all"):
            if self.num_needles == 0:
                return True
            return bool(self._engine.value_presence(haystack, self._case).all())

    def count_matches(self, haystack: utf8.TextLike) -> int:
        with trace.span("amt.api.count_matches"):
            return self._engine.count(haystack, self._case)

    def all_matches(self, haystack: utf8.TextLike) -> List[ac.Match]:
        """A list of ``Match(pos, value)``; bulk consumers prefer
        :meth:`all_matches_arrays`."""
        with trace.span("amt.api.all_matches"):
            ms = self._engine.matches(haystack, self._case)
            values = self._machine.values
            return list(
                map(ac.Match, ms.ends.tolist(), map(values.__getitem__, ms.value_ids.tolist()))
            )

    def all_matches_arrays(self, haystack: utf8.TextLike):
        """(ends, value_ids) numpy arrays in emission order (``ends`` are
        byte positions one past each match; ``value_ids`` index
        :attr:`automaton` ``.values``)."""
        with trace.span("amt.api.all_matches_arrays"):
            ms = self._engine.matches(haystack, self._case)
        return ms.ends, ms.value_ids

    def distributed(self, mesh, inner: str = "auto", **kw):
        """A ``parallel.DistributedAcEngine`` scanning this searcher's
        automaton over a ``(data, seq, needle)`` mesh (``parallel.make_mesh``):
        counts reduced over the shards, match sets identical to the single
        device's for any mesh shape.

        An IgnoreCase searcher scans the raw bytes with the composed case
        DFA (``models.case_dfa``), its needle groups composed too, under the
        JAX package's gate: whole-code-point needles and at most
        ``COMPOSED_CI_MAX_STATES`` states; else ``ValueError``.  Unlike
        ``MatchEngine._composed`` it does not ask for a single-pass engine:
        the mesh builds each needle group's own composed machine."""
        from .parallel import DistributedAcEngine

        machine, sub_build = self._machine, None
        if self._case is IGNORE_CASE:
            m = self._machine
            why = "whole-code-point needles and at most %d states" % COMPOSED_CI_MAX_STATES
            if m.n_states > COMPOSED_CI_MAX_STATES or not case_dfa.eligible(m.needles):
                raise ValueError(f"IgnoreCase distributed scans need the composed case DFA ({why})")
            try:
                machine = case_dfa.compose_build(list(zip(m.needles, m.values)), machine=m)
            except ValueError as e:
                raise ValueError(
                    f"IgnoreCase distributed scans need the composed case DFA ({why}): {e}"
                ) from e
            sub_build = case_dfa.compose_build  # needle groups stay composed
        return DistributedAcEngine(machine, mesh, inner=inner, sub_build=sub_build, **kw)


__all__ = ["Searcher"]
