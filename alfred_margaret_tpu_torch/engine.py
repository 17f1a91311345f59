"""Engine dispatch of the port: count, containsAny, containsAll and matches on
a device.

Counterpart of ``alfred_margaret_tpu/engine.py:MatchEngine`` for
CaseSensitive haystacks (``count``, ``contains_any``, ``value_presence``,
``matches``, ``stage``).  Backends:

* ``python`` - the scalar oracle of ``models.ac`` (its fold, or a scalar
  state pass);
* ``cpp``    - the host engine ``native.cpp_engine.CppAcEngine``;
* ``device`` - the port's kernels on ``device`` (``ops.comb_scan.make_engine``);
* ``auto``   - ``python`` below ``AUTO_PYTHON_THRESHOLD`` bytes, else ``device``.

The device is ``"cuda"`` unless the caller asks for ``"cpu"``, where the
kernels' plain torch versions run.  The host/device thresholds of the JAX
package were measured on a TPU; they get re-derived on the H100 later
(ROADMAP Queue A item 7).  ``StagedHaystack`` and ``MatchSet`` are the JAX
package's, less the IgnoreCase fields.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from .models import ac
from .native.cpp_engine import CppAcEngine
from .ops.bitap_scan import BitapAcEngine
from .ops.comb_scan import make_engine
from .ops.pallas_scan import CapacityError, StagedStreams
from .ops.xla_scan import extract_matches
from .utils import utf8
from .utils.case import CASE_SENSITIVE, CaseSensitivity
from .utils.device import resolve_device

#: Inputs smaller than this run on the scalar python path under "auto"
#: (device dispatch overhead dominates below it).
AUTO_PYTHON_THRESHOLD = 4096

_VALID_ENGINES = ("auto", "python", "cpp", "device")


def _has_device(text) -> bool:
    return isinstance(text, StagedHaystack) and text.device is not None


@dataclass
class StagedHaystack:
    """A haystack prepared for repeated scans (see ``MatchEngine.stage``).

    Pass it anywhere a haystack is accepted; on the ``device`` backend the
    operations reuse the staged device streams instead of re-transferring
    per call."""

    case: CaseSensitivity
    data: np.ndarray  # scan bytes
    device: object = None  # backend staging handle (StagedStreams)
    #: The machine whose engine staged this haystack (identity-checked so a
    #: staged haystack cannot silently be scanned by a different searcher).
    owner: object = None

    def __len__(self) -> int:
        return len(self.data)


@dataclass
class MatchSet:
    """All matches of one scan, in emission order.

    ends:      int64 [m] byte index one past each match end
    value_ids: int32 [m] index into the machine's values list
    """

    ends: np.ndarray
    value_ids: np.ndarray

    def __len__(self) -> int:
        return len(self.ends)


class MatchEngine:
    """Runs ``machine`` over haystacks with a chosen backend."""

    def __init__(self, machine: ac.AcMachine, engine: str = "auto", *, device="cuda"):
        if engine not in _VALID_ENGINES:
            raise ValueError(f"unknown engine {engine!r}; expected one of {_VALID_ENGINES}")
        self.machine = machine
        self.engine = engine
        self.device = resolve_device(device)
        self._device_eng = None
        self._cpp = None

    def device_engine(self):
        """The kernel engine on ``self.device`` (built on first use)."""
        if self._device_eng is None:
            self._device_eng = make_engine(self.machine, self.device)
        return self._device_eng

    def _cpp_engine(self) -> CppAcEngine:
        if self._cpp is None:
            self._cpp = CppAcEngine(self.machine)
        return self._cpp

    def _pick(self, n_bytes: int) -> str:
        if self.engine != "auto":
            return self.engine
        return "python" if n_bytes < AUTO_PYTHON_THRESHOLD else "device"

    def _prep(self, text: utf8.TextLike, case: CaseSensitivity):
        """(scan bytes, backend): a haystack staged on the device goes to the
        ``device`` backend."""
        if case is not CASE_SENSITIVE:
            raise NotImplementedError("IgnoreCase is ROADMAP Queue A item 11")
        if isinstance(text, StagedHaystack):
            if text.owner is not None and text.owner is not self.machine:
                # Staged streams carry THIS machine's overlap; another
                # searcher's would miss matches across stream boundaries.
                raise ValueError("staged haystack belongs to a different searcher")
            if text.case is not case:
                raise ValueError("staged haystack was prepared for a different case mode")
            data = text.data
        else:
            data = utf8.to_u8(text)
        return data, "device" if _has_device(text) else self._pick(len(data))

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
        """Prepare a haystack once for repeated scans; on the ``device``
        backend the streams are staged on the device here."""
        data, backend = self._prep(text, case)
        staged = StagedHaystack(case=case, data=data, owner=self.machine)
        if backend == "device":
            staged.device = self.device_engine().stage(data)
        return staged

    def count(self, text: utf8.TextLike, case: CaseSensitivity) -> int:
        data, backend = self._prep(text, case)
        if backend == "python":
            return ac.count_matches(self.machine, data, CASE_SENSITIVE)
        if backend == "cpp":
            return self._cpp_engine().count(data)
        eng = self.device_engine()
        st = self._staged(eng, text)
        return eng.count_staged(st) if st is not None else eng.count(data)

    def contains_any(self, text: utf8.TextLike, case: CaseSensitivity) -> bool:
        data, backend = self._prep(text, case)
        if backend == "python":
            return bool(ac.run_text(False, lambda _acc, _m: ac.Done(True), self.machine, data))
        if backend == "cpp":
            return self._cpp_engine().first_hit(data) >= 0
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
        """All matches (ends one past each match, value ids), emission order."""
        data, backend = self._prep(text, case)
        if backend == "python":
            ends, value_ids = extract_matches(self.machine, self._python_states(data))
        elif backend == "cpp":
            ends, value_ids = self._cpp_engine().matches_arrays(data)
        else:
            eng = self.device_engine()
            st = self._staged(eng, text)
            if st is not None:
                ends, value_ids = eng.matches_arrays_staged(st)
            else:
                ends, value_ids = eng.matches_arrays(data)
        return MatchSet(ends=ends, value_ids=value_ids)

    def value_presence(self, text: utf8.TextLike, case: CaseSensitivity) -> np.ndarray:
        """bool [n_values]: which values have at least one match."""
        data, backend = self._prep(text, case)
        m = self.machine
        if backend == "python":
            states = self._python_states(data)
            return ac.presence_of_states(m, states[m.match_count[states] > 0], len(m.values))
        if backend == "cpp":
            return self._cpp_engine().value_presence(data, len(m.values))
        eng = self.device_engine()
        st = self._staged(eng, text)
        if st is None:
            st = eng.stage(data)
        if isinstance(eng, BitapAcEngine):
            # One sticky scan: each track's end bit flags its needle, and
            # value ids are needle entries.
            return eng.needle_presence_staged(st)
        _, hit = eng.match_positions_staged(st)
        return ac.presence_of_states(m, hit, len(m.values))


__all__ = ["AUTO_PYTHON_THRESHOLD", "CppAcEngine", "MatchEngine", "MatchSet", "StagedHaystack"]
