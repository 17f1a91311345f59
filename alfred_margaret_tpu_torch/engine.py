"""Engine dispatch of the port: count and stage, on an explicit device.

Counterpart of ``alfred_margaret_tpu/engine.py:MatchEngine`` for
CaseSensitive counting.  Backends:

* ``python`` - the scalar oracle ``models.ac.count_matches``;
* ``cpp``    - the shared host engine ``native.cpp_engine.CppAcEngine``;
* ``device`` - the port's kernels on ``device`` (``ops.comb_scan.make_engine``);
* ``auto``   - ``python`` below ``AUTO_PYTHON_THRESHOLD`` bytes, else ``device``.

The host/device thresholds of the JAX package were measured on a TPU; they
get re-derived on the H100 later (ROADMAP Queue A item 7).  Staged haystacks
are the JAX package's ``StagedHaystack`` with the same owner and case checks.
"""

from __future__ import annotations

from alfred_margaret_tpu.engine import AUTO_PYTHON_THRESHOLD, StagedHaystack, _has_device
from alfred_margaret_tpu.models import ac
from alfred_margaret_tpu.utils import utf8
from alfred_margaret_tpu.utils.case import CASE_SENSITIVE, CaseSensitivity

from .ops.comb_scan import make_engine
from .ops.pallas_scan import StagedStreams
from .utils.device import resolve_device

_VALID_ENGINES = ("auto", "python", "cpp", "device")


class MatchEngine:
    """Counts ``machine``'s matches over haystacks with a chosen backend."""

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

    def _cpp_engine(self):
        if self._cpp is None:
            from alfred_margaret_tpu.native.cpp_engine import CppAcEngine

            self._cpp = CppAcEngine(self.machine)
        return self._cpp

    def _pick(self, n_bytes: int) -> str:
        if self.engine != "auto":
            return self.engine
        return "python" if n_bytes < AUTO_PYTHON_THRESHOLD else "device"

    def _prep(self, text: utf8.TextLike, case: CaseSensitivity):
        if case is not CASE_SENSITIVE:
            raise NotImplementedError("IgnoreCase is ROADMAP Queue A item 11")
        if isinstance(text, StagedHaystack):
            if text.composed or (text.owner is not None and text.owner is not self.machine):
                # Staged streams carry THIS machine's overlap; another
                # searcher's would miss matches across stream boundaries.
                raise ValueError("staged haystack belongs to a different searcher")
            if text.case is not case:
                raise ValueError("staged haystack was prepared for a different case mode")
            return text.data
        return utf8.to_u8(text)

    def stage(self, text: utf8.TextLike, case: CaseSensitivity) -> StagedHaystack:
        """Prepare a haystack once for repeated scans; on the ``device``
        backend the streams are staged on the device here."""
        data = self._prep(text, case)
        staged = StagedHaystack(case=case, data=data, lowered=None, owner=self.machine)
        if self._pick(len(data)) == "device":
            staged.device = self.device_engine().stage(data)
        return staged

    def count(self, text: utf8.TextLike, case: CaseSensitivity) -> int:
        data = self._prep(text, case)
        backend = "device" if _has_device(text) else self._pick(len(data))
        if backend == "python":
            return ac.count_matches(self.machine, data, CASE_SENSITIVE)
        if backend == "cpp":
            return self._cpp_engine().count(data)
        eng = self.device_engine()
        if _has_device(text):
            st = eng.adopt_staged(text.device) if isinstance(text.device, StagedStreams) else None
            if st is None:
                raise ValueError("staged haystack was staged for another device or layout")
            return eng.count_staged(st)
        return eng.count(data)


__all__ = ["MatchEngine", "AUTO_PYTHON_THRESHOLD"]
