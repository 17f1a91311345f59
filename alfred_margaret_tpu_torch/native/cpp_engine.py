"""ctypes-backed host engine over the dense DFA tables.

The port's copy of the parts of ``alfred_margaret_tpu/native/cpp_engine.py``
it calls: ``CppAcEngine`` (count, first hit, value presence and match
arrays, with the lazily built byte-class tables) and ``_default_threads``.
The same table layout and emission semantics as the device kernels (match
counts per post-byte state), so results are bit-identical: the port's
``cpp`` backend, and the reference every device answer is held against.
``tests/test_torch_host.py`` pins it to the original.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..models.ac import AcMachine
from ..ops.xla_scan import expand_hits
from ..utils import utf8
from . import build


def _default_threads() -> int:
    return min(16, os.cpu_count() or 1)


class CppAcEngine:
    def __init__(self, machine: AcMachine, n_threads: Optional[int] = None):
        self.machine = machine
        self.lib = build.load()
        self.delta = np.ascontiguousarray(machine.delta, dtype=np.int32)
        self.match_count = np.ascontiguousarray(machine.match_count, dtype=np.int32)
        self.overlap = max(0, machine.max_needle_bytes - 1)
        self.n_threads = n_threads if n_threads is not None else _default_threads()
        # Byte-class premultiplied packed tables (lazy; see _class_tables).
        self._cls: Optional[np.ndarray] = None
        self._ctab: Optional[np.ndarray] = None
        self._n_classes = 0
        self._class_bytes_seen = 0
        self._class_state = "unbuilt"  # unbuilt | ready | unavailable

    # Shrinking the table from S*256 to S*C entries (two bytes share a class
    # iff every state moves identically on them) keeps it cache-resident; the
    # match count rides the entry's high byte.  The tables are built once the
    # cumulative scanned bytes reach _CLASS_AMORTIZE times the dense table.
    _CLASS_USE_MIN = 1 << 16  # once built, engage for medium scans too
    _CLASS_AMORTIZE = 20

    def _class_tables(self, n: int):
        """``(ctab, cls, n_classes)`` when the class-packed path should serve
        a scan of ``n`` bytes (built on demand), else None."""
        if self._class_state == "ready":
            if n >= self._CLASS_USE_MIN:
                return self._ctab, self._cls, self._n_classes
            return None
        if self._class_state == "unavailable":
            return None
        self._class_bytes_seen += n
        if self._class_bytes_seen < self._CLASS_AMORTIZE * self.delta.nbytes:
            return None
        if os.environ.get("AMT_HOST_CLASS") == "0":
            self._class_state = "unavailable"
            return None
        cls, reps = self._byte_classes()
        C = len(reps)
        if (
            self.machine.n_states * C >= (1 << 24)
            or int(self.match_count.max(initial=0)) >= 256
        ):
            self._class_state = "unavailable"  # entry fields would overflow
            return None
        dc = self.delta[:, reps].astype(np.int64)  # [S, C] next states
        packed = dc * C | (self.match_count.astype(np.int64)[dc] << 24)
        # Wrap-cast through uint32 (counts >= 128 set the int32 sign bit).
        ctab = np.ascontiguousarray((packed & 0xFFFFFFFF).astype(np.uint32).view(np.int32))
        self._ctab = ctab
        self._cls = np.ascontiguousarray(cls, dtype=np.int32)
        self._n_classes = C
        self._class_state = "ready"
        if n >= self._CLASS_USE_MIN:
            return ctab, self._cls, C
        return None

    def _byte_classes(self):
        """(cls[256] byte -> class, representative byte per class), by
        interning each byte's transition column."""
        cols = np.ascontiguousarray(self.delta.T)  # [256, S]
        cls = np.empty(256, dtype=np.int32)
        groups: dict = {}
        reps: list = []
        for b in range(256):
            idx = groups.setdefault(cols[b].tobytes(), len(reps))
            if idx == len(reps):
                reps.append(b)
            cls[b] = idx
        return cls, np.asarray(reps, dtype=np.int64)

    def count(self, text: utf8.TextLike, n_threads: Optional[int] = None) -> int:
        data = np.ascontiguousarray(utf8.to_u8(text))
        nt = self.n_threads if n_threads is None else n_threads
        if len(data) == 0:
            return 0
        ct = self._class_tables(len(data))
        if ct is not None:
            ctab, cls, _ = ct
            return int(self.lib.am_scan_count_class_mt(
                ctab.ctypes.data, cls.ctypes.data, data.ctypes.data, len(data), self.overlap, nt,
            ))
        return int(self.lib.am_scan_count_mt(
            self.delta.ctypes.data, self.match_count.ctypes.data, self.machine.n_states,
            data.ctypes.data, len(data), self.overlap, nt,
        ))

    def matches_arrays(self, text: utf8.TextLike, n_threads: Optional[int] = None):
        """(ends one past each match, value ids) in emission order: a
        hit-only native scan and the CSR output expansion."""
        data = np.ascontiguousarray(utf8.to_u8(text))
        if len(data) == 0:
            return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int32)
        nt = self.n_threads if n_threads is None else n_threads
        # First-try capacity sized for ~1.5% hit density; denser inputs pay
        # one full rescan with the exact size.
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

    def first_hit(self, text: utf8.TextLike, n_threads: Optional[int] = None) -> int:
        """Byte position one past SOME match, or -1 when none: all threads
        stop as soon as any finds a hit, so the position is an existence
        witness, not the leftmost."""
        data = np.ascontiguousarray(utf8.to_u8(text))
        if len(data) == 0:
            return -1
        nt = self.n_threads if n_threads is None else n_threads
        ct = self._class_tables(len(data))
        if ct is not None:
            ctab, cls, _ = ct
            return int(self.lib.am_scan_first_hit_class(
                ctab.ctypes.data, cls.ctypes.data, data.ctypes.data, len(data), self.overlap, nt,
            ))
        return int(self.lib.am_scan_first_hit(
            self.delta.ctypes.data, self.match_count.ctypes.data, data.ctypes.data, len(data),
            self.overlap, nt,
        ))

    def value_presence(self, text: utf8.TextLike, n_values: int,
                       n_threads: Optional[int] = None) -> np.ndarray:
        """bool [n_values] presence bitmap; the scan stops early once every
        value has been seen."""
        data = np.ascontiguousarray(utf8.to_u8(text))
        seen = np.zeros(max(n_values, 1), dtype=np.uint8)
        if len(data) == 0 or n_values == 0:
            return seen.astype(bool)[:n_values]
        nt = self.n_threads if n_threads is None else n_threads
        out_offset = np.ascontiguousarray(self.machine.out_offset, dtype=np.int32)
        out_values = np.ascontiguousarray(self.machine.out_values, dtype=np.int32)
        ct = self._class_tables(len(data))
        if ct is not None:
            ctab, cls, n_classes = ct
            self.lib.am_scan_all_values_class(
                ctab.ctypes.data, cls.ctypes.data, n_classes,
                out_offset.ctypes.data, out_values.ctypes.data, n_values,
                data.ctypes.data, len(data), self.overlap, nt, seen.ctypes.data,
            )
            return seen.astype(bool)
        self.lib.am_scan_all_values(
            self.delta.ctypes.data, self.match_count.ctypes.data,
            out_offset.ctypes.data, out_values.ctypes.data, n_values,
            data.ctypes.data, len(data), self.overlap, nt, seen.ctypes.data,
        )
        return seen.astype(bool)


__all__ = ["CppAcEngine"]
