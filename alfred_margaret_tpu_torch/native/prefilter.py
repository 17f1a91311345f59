"""Host prefilter-verify engine for large needle sets (min length >= 5).

A copy of ``alfred_margaret_tpu/native/prefilter.py``: the ``cpp``
backend's count and containsAny for sets of 2,000 needles or more on hosts
of 8 cores or more (``MatchEngine._prefilter``).  Big automata blow every
cache the dense-DFA host scan has (10k needles = ~6 MB of transition rows
touched per byte at random).  This engine changes the algorithm instead of
the layout: every match START begins with some needle's first 5 bytes, so a
rolling 5-byte window probed against an L1-resident blocked Bloom filter
rejects ~99% of positions in a handful of ALU ops, and only candidates touch
the exact prefix map + tail memcmp (``native/am_native.cpp::am_prefilter_*``).

Exactness: counts are (start, needle) pairs with a full byte-equal match,
the same multiset total as the AC engines' (end, needle) emissions,
overlaps and duplicate needles included.  Bloom false positives only cost a
map probe; map hits compare the exact 5-byte key and then the needle tail.

Gate: every needle must be >= 5 bytes (``eligible``); shorter-needle sets
keep the DFA engines.  IgnoreCase works on the lowered stream exactly like
the other host paths (the dispatcher hands this engine lowered bytes and
lowered needles); never on a composed case-folding machine, whose needles
keep their original case.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import numpy as np

from ..utils import utf8
from . import build as native_build

MIN_PREFIX = 5


def eligible(needles: Sequence[bytes]) -> bool:
    return len(needles) > 0 and all(len(n) >= MIN_PREFIX for n in needles)


def _mix5(w: np.ndarray) -> np.ndarray:
    """Python mirror of the C++ multiplicative hash (must match exactly;
    only bits >= 24 of the product are usable)."""
    with np.errstate(over="ignore"):
        return w.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)


class PrefilterEngine:
    """ctypes wrapper around the native prefilter scan."""

    def __init__(self, needles: Sequence[utf8.TextLike], n_threads: Optional[int] = None):
        needles = [utf8.to_bytes(n) for n in needles]
        if not eligible(needles):
            raise ValueError("prefilter needs non-empty needles of >= 5 bytes")
        self._lib = native_build.load()
        self.n_threads = n_threads
        self.needles = needles

        # 5-byte prefix keys (little-endian packing, matching the C++
        # rolling window: data[p] in byte 0 .. data[p+4] in byte 4).
        key_of = np.array(
            [int.from_bytes(n[:MIN_PREFIX], "little") for n in needles],
            dtype=np.uint64,
        )
        uniq = np.unique(key_of)
        n_keys = len(uniq)

        # Blocked Bloom filter: one word per key-hash, two bits tested.
        words = 1 << max(11, int(np.ceil(np.log2(max(2, n_keys)))))
        words = min(words, 1 << 16)
        h = _mix5(uniq)
        widx = ((h >> np.uint64(24)) & np.uint64(words - 1)).astype(np.int64)
        bit1 = ((h >> np.uint64(54)) & np.uint64(31)).astype(np.int64)
        bit2 = ((h >> np.uint64(59)) & np.uint64(31)).astype(np.int64)
        bloom = np.zeros(words, dtype=np.uint32)
        np.bitwise_or.at(bloom, widx, (np.uint32(1) << bit1.astype(np.uint32)))
        np.bitwise_or.at(bloom, widx, (np.uint32(1) << bit2.astype(np.uint32)))
        self._bloom = bloom
        self._bloom_words = words

        # Exact prefix map: open addressing, linear probing — slot layout
        # must match the C++ probe ((h >> 40) & mask, +1 steps).
        slots = 1 << int(np.ceil(np.log2(max(4, 2 * n_keys))))
        KEY_EMPTY = np.uint64(0xFFFFFFFFFFFFFFFF)
        keys = np.full(slots, KEY_EMPTY, dtype=np.uint64)
        slot_of_key = {}
        mask = slots - 1
        for k, hh in zip(uniq, _mix5(uniq)):
            s = int((hh >> np.uint64(40)) & np.uint64(mask))
            while keys[s] != KEY_EMPTY:
                s = (s + 1) & mask
            keys[s] = k
            slot_of_key[int(k)] = s
        # Needle groups per slot (CSR), duplicates listed individually.
        per_slot: List[List[int]] = [[] for _ in range(slots)]
        for nid, k in enumerate(key_of):
            per_slot[slot_of_key[int(k)]].append(nid)
        grp_off = np.zeros(slots + 1, dtype=np.int32)
        grp_needles = np.zeros(len(needles), dtype=np.int32)
        pos = 0
        for s in range(slots):
            grp_off[s] = pos
            for nid in per_slot[s]:
                grp_needles[pos] = nid
                pos += 1
        grp_off[slots] = pos
        self._keys = keys
        self._slots = slots
        self._grp_off = grp_off
        self._grp_needles = grp_needles

        nb_off = np.zeros(len(needles) + 1, dtype=np.int32)
        for i, n in enumerate(needles):
            nb_off[i + 1] = nb_off[i] + len(n)
        self._nb_off = nb_off
        self._nb_bytes = np.frombuffer(b"".join(needles), dtype=np.uint8).copy()

    def _args(self, data: np.ndarray):
        c = ctypes.c_void_p
        return (
            self._bloom.ctypes.data_as(c),
            ctypes.c_int64(self._bloom_words),
            self._keys.ctypes.data_as(c),
            self._grp_off.ctypes.data_as(c),
            self._grp_needles.ctypes.data_as(c),
            ctypes.c_int64(self._slots),
            self._nb_off.ctypes.data_as(c),
            self._nb_bytes.ctypes.data_as(c),
            data.ctypes.data_as(c),
            ctypes.c_int64(len(data)),
        )

    def count(self, text: utf8.TextLike, n_threads: Optional[int] = None) -> int:
        data = np.ascontiguousarray(utf8.to_u8(text))
        nt = n_threads or self.n_threads or native_build.default_threads()
        return int(self._lib.am_prefilter_count(*self._args(data), ctypes.c_int32(nt)))

    def first_hit(self, text: utf8.TextLike) -> int:
        """First verified match start, or -1 (containsAny early exit)."""
        data = np.ascontiguousarray(utf8.to_u8(text))
        return int(self._lib.am_prefilter_first(*self._args(data)))


__all__ = ["PrefilterEngine", "eligible", "MIN_PREFIX"]
