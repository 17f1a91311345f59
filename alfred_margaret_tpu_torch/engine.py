"""Engine dispatch of the port: count, containsAny, containsAll and matches on
an explicit device.

Counterpart of ``alfred_margaret_tpu/engine.py:MatchEngine`` for
CaseSensitive haystacks (``count``, ``contains_any``, ``value_presence``,
``matches``, ``stage``).  Backends:

* ``python`` - the scalar oracle of ``models.ac`` (its fold, or a scalar
  state pass);
* ``cpp``    - the shared host engine ``native.cpp_engine.CppAcEngine``;
* ``device`` - the port's kernels on ``device`` (``ops.comb_scan.make_engine``);
* ``auto``   - ``python`` below ``AUTO_PYTHON_THRESHOLD`` bytes, else ``device``.

The host/device thresholds of the JAX package were measured on a TPU; they
get re-derived on the H100 later (ROADMAP Queue A item 7).  Staged haystacks
are the JAX package's ``StagedHaystack`` with the same owner and case checks.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from alfred_margaret_tpu.engine import AUTO_PYTHON_THRESHOLD, MatchSet, StagedHaystack, _has_device
from alfred_margaret_tpu.models import ac
from alfred_margaret_tpu.native import cpp_engine as _cpp
from alfred_margaret_tpu.utils import utf8
from alfred_margaret_tpu.utils.case import CASE_SENSITIVE, CaseSensitivity

from .ops.bitap_scan import BitapAcEngine
from .ops.comb_scan import make_engine
from .ops.pallas_scan import CapacityError, StagedStreams
from .ops.xla_scan import expand_hits, extract_matches
from .utils.device import resolve_device

_VALID_ENGINES = ("auto", "python", "cpp", "device")


class CppAcEngine(_cpp.CppAcEngine):
    """The shared host C++ engine.  ``matches_arrays`` is the original's
    with the port's ``expand_hits``: the original imports it from
    ``alfred_margaret_tpu.ops.xla_scan``, which imports ``jax``."""

    def matches_arrays(self, text: utf8.TextLike, n_threads: Optional[int] = None):
        data = np.ascontiguousarray(utf8.to_u8(text))
        if len(data) == 0:
            return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int32)
        nt = self.n_threads if n_threads is None else n_threads
        cap = max(4096, len(data) // 64)
        ct = self._class_tables(len(data))
        while True:
            pos = np.empty(cap, dtype=np.int64)
            st = np.empty(cap, dtype=np.int32)
            if ct is not None:
                ctab, cls, n_classes = ct
                total = int(self.lib.am_scan_hits_class_mt(
                    ctab.ctypes.data, cls.ctypes.data, n_classes, data.ctypes.data, len(data),
                    self.overlap, nt, pos.ctypes.data, st.ctypes.data, cap,
                ))
            else:
                total = int(self.lib.am_scan_hits_mt(
                    self.delta.ctypes.data, self.match_count.ctypes.data, self.machine.n_states,
                    data.ctypes.data, len(data), self.overlap, nt,
                    pos.ctypes.data, st.ctypes.data, cap,
                ))
            if total <= cap:
                break
            cap = total + 16
        return expand_hits(self.machine, pos[:total], st[:total])


class MatchEngine:
    """Runs ``machine`` over haystacks with a chosen backend."""

    def __init__(self, machine: ac.AcMachine, engine: str = "auto", *, device):
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
            if text.composed or (text.owner is not None and text.owner is not self.machine):
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
        staged = StagedHaystack(case=case, data=data, lowered=None, owner=self.machine)
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
        return MatchSet(ends=ends, value_ids=value_ids, lowered=None)

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


__all__ = ["AUTO_PYTHON_THRESHOLD", "CppAcEngine", "MatchEngine"]
