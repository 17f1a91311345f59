"""Engine dispatch of the port: count, containsAny, containsAll and matches on
a device, in both case modes.

Counterpart of ``alfred_margaret_tpu/engine.py:MatchEngine`` (``count``,
``contains_any``, ``value_presence``, ``matches``, ``stage``).  Backends:

* ``python`` - the scalar oracle of ``models.ac`` (its fold, or a scalar
  state pass);
* ``cpp``    - the host engine ``native.cpp_engine.CppAcEngine``;
* ``xla``    - the reference scan engine ``ops.xla_scan.XlaAcEngine`` on
  ``device`` (torch gathers, one time step at a time; no kernel);
* ``device`` - the port's kernels on ``device``: the single-pass engine of
  ``ops.comb_scan.make_engine``, else the needle-grouped
  ``ops.grouped.GroupedAcEngine``, else, for a set that no grouping holds
  (a large set with an empty needle), ``XlaAcEngine``, as the JAX package
  falls back to its XLA engine;
* ``auto``   - ``python`` below ``AUTO_PYTHON_THRESHOLD`` bytes, else ``device``.

IgnoreCase takes one of two routes, as in the JAX package.  The composed
case DFA (``models.case_dfa``) folds case inside an ordinary byte DFA over
the raw bytes, so every backend scans it case-sensitively and match ends
come out raw; it is built for a staged haystack or a one-shot haystack of
``AUTO_COMPOSE_BYTES`` or more, for whole-code-point needles and at most
``COMPOSED_CI_MAX_STATES`` states, and kept only where ``make_engine`` holds
it in one pass.  Else the lowering path lowers the haystack on the host
(``utils.utf8.lower_transform``), scans the lowered bytes with the
CaseSensitive machine, and maps match ends back to raw coordinates.

The device is ``"cuda"`` unless the caller asks for ``"cpu"``, where the
kernels' plain torch versions run.  The host/device thresholds of the JAX
package were measured on a TPU; they get re-derived on the H100 later
(ROADMAP Queue A item 7).  ``StagedHaystack`` and ``MatchSet`` are the JAX
package's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from .models import ac, case_dfa
from .native.cpp_engine import CppAcEngine
from .ops.bitap_scan import BitapAcEngine
from .ops.comb_scan import make_engine
from .ops.grouped import GroupedAcEngine
from .ops.pallas_scan import CapacityError, StagedStreams
from .ops.xla_scan import XlaAcEngine, extract_matches
from .utils import utf8
from .utils.case import CASE_SENSITIVE, IGNORE_CASE, CaseSensitivity
from .utils.device import resolve_device

#: Inputs smaller than this run on the scalar python path under "auto"
#: (device dispatch overhead dominates below it).
AUTO_PYTHON_THRESHOLD = 4096

#: Automata above this many CaseSensitive states take the IgnoreCase lowering
#: path, not the composed case DFA (the JAX package's default of
#: ``composed_ci_max_states``; its ``AMT_COMPOSED_CI`` override is not
#: ported yet, ROADMAP Queue A item 19).
COMPOSED_CI_MAX_STATES = 4096

_VALID_ENGINES = ("auto", "python", "cpp", "xla", "device")


def _has_device(text) -> bool:
    return isinstance(text, StagedHaystack) and text.device is not None


@dataclass
class StagedHaystack:
    """A haystack prepared for repeated scans (see ``MatchEngine.stage``).

    Pass it anywhere a haystack is accepted; on the ``device`` backend the
    operations reuse the staged device streams instead of re-transferring
    per call."""

    case: CaseSensitivity
    data: np.ndarray  # scan bytes (lowered on the IgnoreCase lowering path)
    #: The lowering of ``data`` with its raw coordinates (the IgnoreCase
    #: lowering path only).
    lowered: Optional[utf8.LoweredText] = None
    #: Backend staging handle (StagedStreams); None on the host backends and
    #: on the reference scan engine, which keeps only the bytes.
    device: object = None
    #: True when staged by the composed case-DFA engine: ``data`` is the RAW
    #: bytes and the staging belongs to the composed machine's engines.
    composed: bool = False
    #: The machine whose engine staged this haystack (identity-checked so a
    #: staged haystack cannot silently be scanned by a different searcher).
    owner: object = None

    def __len__(self) -> int:
        return len(self.data)


@dataclass
class MatchSet:
    """All matches of one scan, in emission order.

    ends:      int64 [m] byte index one past each match end (raw coords)
    value_ids: int32 [m] index into the machine's values list
    lowered:   the LoweredText used (IgnoreCase lowering path only)
    """

    ends: np.ndarray
    value_ids: np.ndarray
    lowered: Optional[utf8.LoweredText] = None

    def __len__(self) -> int:
        return len(self.ends)


class MatchEngine:
    """Runs ``machine`` over haystacks with a chosen backend."""

    #: Haystack size from which an IgnoreCase scan builds the composed case
    #: DFA (the JAX package's): the build is paid once per searcher, and
    #: small one-shot scans stay on the lowering path.
    AUTO_COMPOSE_BYTES = 4 << 20

    def __init__(self, machine: ac.AcMachine, engine: str = "auto", *, device="cuda"):
        if engine not in _VALID_ENGINES:
            raise ValueError(f"unknown engine {engine!r}; expected one of {_VALID_ENGINES}")
        self.machine = machine
        self.engine = engine
        self.device = resolve_device(device)
        self._device_eng = None
        self._cpp = None
        self._xla = None
        self._ci = False  # False: not tried yet; None: unavailable

    def device_engine(self):
        """The engine of the ``device`` backend, built on first use: the
        single-pass engine of ``make_engine``, else, for a needle set that none
        holds, the needle-grouped ``GroupedAcEngine``, else (a machine with an
        empty needle, which no grouping can split) the reference scan engine,
        as the JAX package does (``alfred_margaret_tpu/engine.py:220-227``)."""
        if self._device_eng is None:
            try:
                self._device_eng = make_engine(self.machine, self.device)
            except CapacityError:
                try:
                    self._device_eng = GroupedAcEngine(self.machine, device=self.device)
                except CapacityError:
                    self._device_eng = self._xla_engine()
        return self._device_eng

    def _xla_engine(self) -> XlaAcEngine:
        if self._xla is None:
            self._xla = XlaAcEngine(self.machine, device=self.device)
        return self._xla

    def _cpp_engine(self) -> CppAcEngine:
        if self._cpp is None:
            self._cpp = CppAcEngine(self.machine)
        return self._cpp

    def _pick(self, n_bytes: int) -> str:
        if self.engine != "auto":
            return self.engine
        return "python" if n_bytes < AUTO_PYTHON_THRESHOLD else "device"

    # -- the composed IgnoreCase engine (JAX ``engine.py:136-184``) --------------

    def _composed(self, case: CaseSensitivity, text=None) -> Optional["MatchEngine"]:
        """The composed case-folding engine for IGNORE_CASE scans, or None.

        Built at first use: ``text=None`` (staging) or a one-shot haystack of
        ``AUTO_COMPOSE_BYTES`` or more asks for it; a ``StagedHaystack``
        delegates only if it was staged through the composed path.  It needs
        whole-code-point needles and at most ``COMPOSED_CI_MAX_STATES``
        states, and, where the device may run it, a single-pass engine that
        holds the composed machine: the grouped engine builds its groups from
        ``machine.needles``, which scan raw bytes case-sensitively, so a
        composed machine that only groups would drop every uppercase match.
        Such a set takes the lowering path, where the grouped engine runs
        the CaseSensitive machine over lowered bytes, which is exact."""
        if case is not IGNORE_CASE:
            return None
        if isinstance(text, StagedHaystack):
            if text.composed and self._ci and text.owner is self._ci.machine:
                return self._ci
            return None
        if self._ci is False:
            if text is not None and len(text) < self.AUTO_COMPOSE_BYTES:
                return None  # not worth building yet; retry on a larger input
            self._ci = None
            m = self.machine
            if m.n_states <= COMPOSED_CI_MAX_STATES and case_dfa.eligible(m.needles):
                try:
                    cm = case_dfa.compose_build(list(zip(m.needles, m.values)), machine=m)
                    ci = MatchEngine(cm, self.engine, device=self.device)
                    if self.engine in ("auto", "device"):
                        ci._device_eng = make_engine(cm, self.device)
                    self._ci = ci
                except (CapacityError, ValueError):  # no single pass; product too large
                    self._ci = None
        return self._ci

    def _prep(self, text: utf8.TextLike, case: CaseSensitivity, need_coords: bool = True):
        """(scan bytes, lowering or None, backend): a haystack staged on the
        device goes to the ``device`` backend, and the ``device`` backend
        whose engine is the reference scan engine is the ``xla`` backend.
        IgnoreCase haystacks are lowered here (``need_coords=False``, for
        counting and existence, skips the raw-coordinate maps)."""
        if isinstance(text, StagedHaystack):
            if text.composed:
                # Raw bytes staged for a composed engine: valid only inside
                # it, where they are scanned case-sensitively.
                if case is not CASE_SENSITIVE or text.owner is not self.machine:
                    raise ValueError("staged haystack belongs to a different searcher")
            elif text.owner is not None and text.owner is not self.machine:
                # Staged streams carry THIS machine's overlap; another
                # searcher's would miss matches across stream boundaries.
                raise ValueError("staged haystack belongs to a different searcher")
            elif text.case is not case:
                raise ValueError("staged haystack was prepared for a different case mode")
            data, lt = text.data, text.lowered
        elif case is IGNORE_CASE:
            lt = utf8.lower_transform(text, need_coords=need_coords)
            data = lt.lowered
        else:
            data, lt = utf8.to_u8(text), None
        if _has_device(text):
            return data, lt, "device"
        backend = self._pick(len(data))
        if backend == "device" and isinstance(self.device_engine(), XlaAcEngine):
            return data, lt, "xla"
        return data, lt, backend

    def _staged(self, eng, text) -> Optional[StagedStreams]:
        """The device streams of a staged haystack, adopted by ``eng``; None
        for a haystack that is not staged on the device."""
        if not _has_device(text):
            return None
        st = eng.adopt_staged(text.device) if isinstance(text.device, StagedStreams) else None
        if st is None:
            raise ValueError("staged haystack was staged for another device or layout")
        return st

    def _python_states(self, data: np.ndarray) -> np.ndarray:
        """Scalar byte-DFA pass: the state after every byte."""
        delta = self.machine.delta
        out = np.empty(len(data), dtype=np.int32)
        state = 0
        for i, b in enumerate(memoryview(utf8.to_bytes(data))):
            state = delta[state, b]
            out[i] = state
        return out

    def stage(self, text: utf8.TextLike, case: CaseSensitivity) -> StagedHaystack:
        """Prepare a haystack once for repeated scans: IgnoreCase goes to the
        composed engine (raw bytes) or is lowered here; on the ``device``
        backend the streams are staged on the device here (the reference
        scan engine keeps only the bytes, as the JAX package's does)."""
        ci = self._composed(case)
        if ci is not None:
            staged = ci.stage(text, CASE_SENSITIVE)
            staged.case = case  # the caller staged for IGNORE_CASE
            staged.composed = True
            return staged
        data, lt, backend = self._prep(text, case)
        staged = StagedHaystack(case=case, data=data, lowered=lt, owner=self.machine)
        if backend == "device":
            staged.device = self.device_engine().stage(data)
        return staged

    def count(self, text: utf8.TextLike, case: CaseSensitivity) -> int:
        ci = self._composed(case, text)
        if ci is not None:
            return ci.count(text, CASE_SENSITIVE)
        data, _, backend = self._prep(text, case, need_coords=False)
        if backend == "python":
            # Lowered bytes scan case-sensitively: the same answer.
            return ac.count_matches(self.machine, data, CASE_SENSITIVE)
        if backend == "cpp":
            return self._cpp_engine().count(data)
        if backend == "xla":
            return self._xla_engine().count(data)
        eng = self.device_engine()
        st = self._staged(eng, text)
        return eng.count_staged(st) if st is not None else eng.count(data)

    def contains_any(self, text: utf8.TextLike, case: CaseSensitivity) -> bool:
        ci = self._composed(case, text)
        if ci is not None:
            return ci.contains_any(text, CASE_SENSITIVE)
        data, _, backend = self._prep(text, case, need_coords=False)
        if backend == "python":
            return bool(ac.run_text(False, lambda _acc, _m: ac.Done(True), self.machine, data))
        if backend == "cpp":
            return self._cpp_engine().first_hit(data) >= 0
        if backend == "xla":
            return self._xla_engine().count(data) > 0
        eng = self.device_engine()
        st = self._staged(eng, text)
        try:
            return eng.contains_staged_early(st) if st is not None else eng.contains(data)
        except CapacityError:
            # The sticky view has one state more than the machine and can
            # overflow the table where the count fits; the reference then
            # answers count > 0 (alfred_margaret_tpu/engine.py:565-572).
            return (eng.count_staged(st) if st is not None else eng.count(data)) > 0

    def matches(self, text: utf8.TextLike, case: CaseSensitivity) -> MatchSet:
        """All matches (ends one past each match in raw coordinates, value
        ids), emission order."""
        ci = self._composed(case, text)
        if ci is not None:
            # The composed machine scans raw bytes: the ends are raw already.
            return ci.matches(text, CASE_SENSITIVE)
        data, lt, backend = self._prep(text, case)
        if backend == "python":
            ends, value_ids = extract_matches(self.machine, self._python_states(data))
        elif backend == "xla":
            ends, value_ids = extract_matches(self.machine, self._xla_engine().final_states(data))
        elif backend == "cpp":
            ends, value_ids = self._cpp_engine().matches_arrays(data)
        else:
            eng = self.device_engine()
            st = self._staged(eng, text)
            if st is not None:
                ends, value_ids = eng.matches_arrays_staged(st)
            else:
                ends, value_ids = eng.matches_arrays(data)
        if lt is not None and len(ends):
            ends = lt.map_ends_to_raw(ends)
        return MatchSet(ends=ends, value_ids=value_ids, lowered=lt)

    def value_presence(self, text: utf8.TextLike, case: CaseSensitivity) -> np.ndarray:
        """bool [n_values]: which values have at least one match."""
        ci = self._composed(case, text)
        if ci is not None:
            return ci.value_presence(text, CASE_SENSITIVE)
        data, _, backend = self._prep(text, case, need_coords=False)
        m = self.machine
        if backend == "python":
            states = self._python_states(data)
            return ac.presence_of_states(m, states[m.match_count[states] > 0], len(m.values))
        if backend == "cpp":
            return self._cpp_engine().value_presence(data, len(m.values))
        if backend == "xla":
            hit = np.flatnonzero(self._xla_engine().state_hits(data))
            return ac.presence_of_states(m, hit, len(m.values))
        eng = self.device_engine()
        st = self._staged(eng, text)
        if st is None:
            st = eng.stage(data)
        if isinstance(eng, BitapAcEngine):
            # One sticky scan: each track's end bit flags its needle, and
            # value ids are needle entries.  None: a trap fired, and the
            # flags could under-report; the extraction route decides.
            pres = eng.needle_presence_staged(st)
            if pres is not None:
                return pres
        if isinstance(eng, GroupedAcEngine):
            # Group-local states: each group reads its own presence.
            return eng.value_presence_staged(st, len(m.values))
        _, hit = eng.match_positions_staged(st)
        return ac.presence_of_states(m, hit, len(m.values))


__all__ = [
    "AUTO_PYTHON_THRESHOLD",
    "COMPOSED_CI_MAX_STATES",
    "CppAcEngine",
    "MatchEngine",
    "MatchSet",
    "StagedHaystack",
]
