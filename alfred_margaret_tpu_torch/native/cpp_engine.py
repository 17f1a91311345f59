"""ctypes-backed host engine over the dense DFA tables.

The port's copy of the parts of ``alfred_margaret_tpu/native/cpp_engine.py``
it calls: ``CppAcEngine`` (count, per-position states, first hit, value
presence, match arrays and the Replacer's segmented window rescan, with the
lazily built byte-class tables, and ``memscan_baseline``, the host memory
roof), ``_default_threads``, and the 64-bit host
bitap oracle ``CppBitapEngine`` with its planners ``plan_host_bitap`` and
``plan_host_bitap_ci``.
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

    def final_states(self, text: utf8.TextLike, n_threads: Optional[int] = None) -> np.ndarray:
        """int32 [n]: the state after every byte of ``text`` (the host
        oracle of the engines' ``final_states``)."""
        data = np.ascontiguousarray(utf8.to_u8(text))
        out = np.empty(len(data), dtype=np.int32)
        if len(data) == 0:
            return out
        nt = self.n_threads if n_threads is None else n_threads
        self.lib.am_scan_states_mt(
            self.delta.ctypes.data, self.machine.n_states, data.ctypes.data, len(data),
            self.overlap, nt, out.ctypes.data,
        )
        return out

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

    def segments_matches_arrays(self, data: np.ndarray, seg_begin: np.ndarray, seg_end: np.ndarray):
        """(ends, value_ids) of scanning each ``[begin, end)`` segment of
        ``data`` from the root state, emission order within each segment,
        segments in input order: the incremental Replacer's window rescan,
        in one native call."""
        data = np.ascontiguousarray(data)
        seg_begin = np.ascontiguousarray(seg_begin, dtype=np.int64)
        seg_end = np.ascontiguousarray(seg_end, dtype=np.int64)
        if len(seg_begin) == 0:
            return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int32)
        cap = 4096
        while True:
            pos = np.empty(cap, dtype=np.int64)
            st = np.empty(cap, dtype=np.int32)
            total = int(self.lib.am_scan_segments_hits(
                self.delta.ctypes.data, self.match_count.ctypes.data, data.ctypes.data,
                seg_begin.ctypes.data, seg_end.ctypes.data, len(seg_begin),
                pos.ctypes.data, st.ctypes.data, cap,
            ))
            if total <= cap:
                break
            cap = total + 16
        return expand_hits(self.machine, pos[:total], st[:total])

    def memscan_baseline(self, text: utf8.TextLike) -> int:
        """XOR-reduce the input once: the host memory-bandwidth roof."""
        data = np.ascontiguousarray(utf8.to_u8(text))
        return int(self.lib.am_memscan_baseline(data.ctypes.data, len(data)))


def plan_host_bitap(machine: AcMachine):
    """(btab uint64[256], seed, endmask) for the 64-bit host bitap, or None.

    One track per needle ENTRY (duplicates included — popcount then counts
    each), so eligibility is simply sum(len) <= 64, no empty needle, and a
    machine whose delta matches needle bytes literally (not a composed
    case-folding DFA).  NUL bytes in needles are fine here: the host scans
    only real data, never pad bytes."""
    if getattr(machine, "composed_ci", False):
        return None
    needles = machine.needles
    if not needles or any(len(n) == 0 for n in needles):
        return None
    if sum(len(n) for n in needles) > 64:
        return None
    btab = np.zeros(256, dtype=np.uint64)
    seed = 0
    endmask = 0
    off = 0
    for nd in needles:
        seed |= 1 << off
        for p, b in enumerate(bytes(nd)):
            btab[b] |= np.uint64(1 << (off + p))
        endmask |= 1 << (off + len(nd) - 1)
        off += len(nd)
    return btab, seed, endmask


def plan_host_bitap_ci(machine: AcMachine):
    """64-bit byte-class plan for a composed case-folding DFA, or None.

    ``(btab, seed, endmask, trap)`` where ``trap`` is a second
    ``(btab, seed, endmask)`` register over the length-changing unlowering
    encodings (İ/Kelvin-K/… — ``models.byteclass``), or None when the
    needle letters have none.  One track per needle ENTRY (original-case
    duplicates each get a track, popcount then counts each), mirroring the
    CaseSensitive host plan."""
    from ..models.byteclass import ci_tracks

    got = ci_tracks(machine)
    if got is None:
        return None
    tracks, traps = got
    if sum(len(ps) * w for ps, w, _ in tracks) > 64:
        return None

    def pack(track_list):
        btab = np.zeros(256, dtype=np.uint64)
        seed = 0
        endmask = 0
        off = 0
        for possets in track_list:
            seed |= 1 << off
            for p, bset in enumerate(possets):
                for b in bset:
                    btab[b] |= np.uint64(1 << (off + p))
            endmask |= 1 << (off + len(possets) - 1)
            off += len(possets)
        return btab, seed, endmask

    entries = []
    for possets, w, _ in tracks:
        entries.extend([possets] * w)
    trap = None
    if traps:
        if sum(len(t) for t in traps) > 64:
            return None
        trap = pack([tuple((b,) for b in t) for t in traps])
    return (*pack(entries), trap)


class CppBitapEngine:
    """Host bitap (shift-AND) engine for small needle sets — an
    algorithmically independent C++ implementation (register automaton, no
    DFA tables) used as a fast conformance oracle in the soak/validation
    harnesses.  Measured equal to the interleaved DFA scan on this host
    (~1.3 GB/s/core; both are uop-throughput-bound once the DFA's 8-way
    interleave hides its load latency), so it is NOT wired into dispatch
    as a fast path — its value is cross-algorithm parity at C++ speed
    (the NFA oracle is scalar Python)."""

    def __init__(self, machine: AcMachine, n_threads: Optional[int] = None):
        self.trap = None
        plan = plan_host_bitap(machine)
        if plan is None:
            ci = plan_host_bitap_ci(machine)
            if ci is None:
                raise ValueError("machine is not host-bitap eligible")
            plan, self.trap = ci[:3], ci[3]
        self.machine = machine
        self.lib = build.load()
        self.btab, self.seed, self.endmask = plan
        self.overlap = max(0, machine.max_needle_bytes - 1)
        self.n_threads = n_threads if n_threads is not None else _default_threads()
        self._dfa = None  # trap-fire fallback (the composed DFA, exact)

    def _trap_fires(self, data: np.ndarray) -> bool:
        if self.trap is None:
            return False
        tb, ts, te = self.trap
        return (
            int(
                self.lib.am_bitap_first(
                    tb.ctypes.data, ts, te, data.ctypes.data, len(data)
                )
            )
            >= 0
        )

    def _fallback(self):
        if self._dfa is None:
            self._dfa = CppAcEngine(self.machine)
        return self._dfa

    def count(self, text: utf8.TextLike, n_threads: Optional[int] = None) -> int:
        data = np.ascontiguousarray(utf8.to_u8(text))
        if len(data) == 0:
            return 0
        if self._trap_fires(data):
            # A length-changing unlowering occurs in the corpus: the
            # byte-class tracks may under-count; use the composed DFA.
            return self._fallback().count(data)
        nt = self.n_threads if n_threads is None else n_threads
        return int(
            self.lib.am_bitap_count_mt(
                self.btab.ctypes.data,
                self.seed,
                self.endmask,
                data.ctypes.data,
                len(data),
                self.overlap,
                nt,
            )
        )

    def first_hit(self, text: utf8.TextLike) -> int:
        """First match END (one past the last byte), or -1.

        Honors the CI trap contract like count/contains: a length-changing
        unlowering anywhere in the corpus could hide an EARLIER match from
        the byte-class tracks, so trap-bearing corpora take the composed
        DFA (a bitap hit alone is genuine, but not provably first)."""
        data = np.ascontiguousarray(utf8.to_u8(text))
        if len(data) == 0:
            return -1
        if self._trap_fires(data):
            return self._fallback().first_hit(data)
        return int(
            self.lib.am_bitap_first(
                self.btab.ctypes.data, self.seed, self.endmask,
                data.ctypes.data, len(data),
            )
        )

    def contains(self, text: utf8.TextLike) -> bool:
        if self.first_hit(text) >= 0:
            return True  # a track hit is genuine even under traps
        data = np.ascontiguousarray(utf8.to_u8(text))
        if len(data) and self._trap_fires(data):
            return self._fallback().first_hit(data) >= 0
        return False


__all__ = [
    "CppAcEngine",
    "CppBitapEngine",
    "plan_host_bitap",
    "plan_host_bitap_ci",
]
