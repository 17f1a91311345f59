"""``Searcher`` on the port's engine.

Counterpart of ``alfred_margaret_tpu/searcher.py:Searcher``: a subclass of
that (jax-free) class whose engine is the port's ``MatchEngine`` on an
explicit device.  ``build``, ``build_with_values``, ``stage``,
``count_matches``, ``contains_any``, ``contains_all``, ``all_matches`` and
``all_matches_arrays`` work, CaseSensitive only; the matching operations,
the needle-list accessors, equality and ``to_json`` are inherited and call
the port's engine.  Every other operation raises ``NotImplementedError``
naming the ROADMAP item that brings it.
"""

from __future__ import annotations

from typing import Any, Iterable, Optional, Sequence, Tuple

from alfred_margaret_tpu import searcher as _ref
from alfred_margaret_tpu.models import ac
from alfred_margaret_tpu.utils import utf8
from alfred_margaret_tpu.utils.case import CASE_SENSITIVE, CaseSensitivity

from .engine import MatchEngine


def _todo(what: str, item: str):
    def method(self, *args, **kwargs):
        raise NotImplementedError(f"{what} is not ported yet: ROADMAP Queue A item {item}")

    method.__name__ = what
    return method


class Searcher(_ref.Searcher):
    """A set of needles with values, matched by the port's kernels."""

    def __init__(
        self,
        case: CaseSensitivity,
        needles_with_values: Sequence[Tuple[bytes, Any]],
        machine: Optional[ac.AcMachine] = None,
        engine: str = "auto",
        *,
        device,
    ):
        if case is not CASE_SENSITIVE:
            raise NotImplementedError("IgnoreCase is ROADMAP Queue A item 11")
        self._case = case
        self._needles = [(utf8.to_bytes(n), v) for n, v in needles_with_values]
        self._machine = machine if machine is not None else ac.build(self._needles)
        self._engine_name = engine
        self._engine = MatchEngine(self._machine, engine, device=device)

    @classmethod
    def build(
        cls, case: CaseSensitivity, needles: Iterable[utf8.TextLike], engine: str = "auto", *, device
    ) -> "Searcher":
        return cls(case, [(utf8.to_bytes(n), ()) for n in needles], engine=engine, device=device)

    @classmethod
    def build_with_values(
        cls,
        case: CaseSensitivity,
        needles_with_values: Iterable[Tuple[utf8.TextLike, Any]],
        engine: str = "auto",
        *,
        device,
    ) -> "Searcher":
        return cls(
            case, [(utf8.to_bytes(n), v) for n, v in needles_with_values],
            engine=engine, device=device,
        )

    @property
    def device(self):
        return self._engine.device

    build_needle_id_searcher = classmethod(_todo("build_needle_id_searcher", "8"))
    from_json = classmethod(_todo("from_json", "8"))
    load_npz = classmethod(_todo("load_npz", "8"))
    set_case_sensitivity = _todo("set_case_sensitivity", "8 and 11")
    map_searcher = _todo("map_searcher", "8")
    __add__ = _todo("__add__", "8")
    adopt_staged = _todo("adopt_staged", "8")
    distributed = _todo("distributed", "16")


__all__ = ["Searcher"]
