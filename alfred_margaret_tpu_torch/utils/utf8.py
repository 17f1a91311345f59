"""UTF-8 byte layer of the port: canonicalization to bytes, the lead-byte
length table the automaton builder reads, Unicode simple lowercasing from a
frozen table, and the IgnoreCase lowering transducer with its raw-byte
coordinate maps.

The port's copy of the parts of ``alfred_margaret_tpu/utils/utf8.py`` it
uses: ``TextLike``, ``to_bytes``, ``to_u8``, ``_LEAD_LEN``; the case tables
(``MAX_CP``, ``LOWER_TABLE``, ``ASCII_LOWER_BYTES``, the unlowering map and
its scalar helpers, ``unicode2utf8``, ``num_code_units``); the strict
streaming decoder (``decode_strict``) and its scalar lowerer;
``skip_code_points_backwards`` and ``raw_match_starts``; the vectorized
codecs (``decode_utf8_np``, ``encode_utf8_np``, ``strict_units_np``,
``lower_units_np``); ``LoweredText``; and ``lower_transform`` with the
native glue (``_native_lib``, ``_lower_encode_map``).  The frozen table
``_data/lower_pairs.npy`` ships with the port and is never regenerated.
``tests/test_torch_host.py`` and ``tests/test_torch_case.py`` pin each to its
original.
"""

from __future__ import annotations

import os
import threading as _threading
from functools import lru_cache
from typing import List, Tuple, Union

import numpy as np

MAX_CP = 0x110000

TextLike = Union[str, bytes, bytearray, np.ndarray]

# ---------------------------------------------------------------------------
# Frozen case tables
# ---------------------------------------------------------------------------

_DATA_DIR = os.path.join(os.path.dirname(__file__), "_data")


def _load_lower_pairs() -> np.ndarray:
    """The frozen (code point, simple lowercase) pairs of ``_data``."""
    return np.load(os.path.join(_DATA_DIR, "lower_pairs.npy"))


_LOWER_PAIRS = _load_lower_pairs()

#: Dense simple-lowercase table over all of Unicode: LOWER_TABLE[cp] == lower cp.
LOWER_TABLE = np.arange(MAX_CP, dtype=np.int32)
LOWER_TABLE[_LOWER_PAIRS[:, 0]] = _LOWER_PAIRS[:, 1]

#: ASCII-only byte-level lowercase map (A-Z += 0x20), identity elsewhere.
ASCII_LOWER_BYTES = np.arange(256, dtype=np.uint8)
ASCII_LOWER_BYTES[ord("A") : ord("Z") + 1] += 0x20


@lru_cache(maxsize=1)
def _unlower_map() -> dict:
    """lower cp -> list of cps that lower to it, descending cp order.

    Order matches the reference's construction (``Unlower.hs:32-40``): a fold
    over ascending code points prepending each, i.e. descending order.
    """
    m: dict = {}
    for cp, low in _LOWER_PAIRS:
        m.setdefault(int(low), []).append(int(cp))
    for low, ups in m.items():
        if LOWER_TABLE[low] == low:
            ups.append(low)
        ups.sort(reverse=True)
    return m


# ---------------------------------------------------------------------------
# Scalar case mapping API (mirrors Utf8.hs:20-75)
# ---------------------------------------------------------------------------


def lower_code_point(c: str) -> str:
    """Simple Unicode lowercase of one code point (``Utf8.hs:145-151``)."""
    return chr(int(LOWER_TABLE[ord(c)]))


def lower_str(text: str) -> str:
    """Lowercase a string per code point (``lowerUtf8``, ``Utf8.hs:138-140``)."""
    return "".join(chr(int(c)) for c in LOWER_TABLE[np.fromiter(map(ord, text), np.int32, len(text))])


def unlower_code_point(c: str) -> str:
    """All code points whose simple lowercase is ``c`` (``Unlower.hs:26-28``).

    Descending code point order; empty if ``c`` is not the lowercase of
    anything (e.g. 'A'), ``c`` itself if it has no case variants.
    """
    cp = ord(c)
    ups = _unlower_map().get(cp)
    if ups is None:
        # Not a lowercase image of any non-trivial mapping: identity preimage
        # {c} if c is its own lowercase, else empty.
        return c if LOWER_TABLE[cp] == cp else ""
    return "".join(map(chr, ups))


# ---------------------------------------------------------------------------
# Scalar UTF-8 codec (mirrors Utf8.hs:154-350)
# ---------------------------------------------------------------------------


def unicode2utf8(cp: int) -> List[int]:
    """Encode one code point to UTF-8 bytes (``Utf8.hs:154-160``)."""
    if cp < 0x80:
        return [cp]
    if cp < 0x800:
        return [0xC0 | (cp >> 6), 0x80 | (cp & 0x3F)]
    if cp < 0x10000:
        return [0xE0 | (cp >> 12), 0x80 | ((cp >> 6) & 0x3F), 0x80 | (cp & 0x3F)]
    return [
        0xF0 | (cp >> 18),
        0x80 | ((cp >> 12) & 0x3F),
        0x80 | ((cp >> 6) & 0x3F),
        0x80 | (cp & 0x3F),
    ]


def to_bytes(text: TextLike) -> bytes:
    """Canonicalize any supported text-like input to UTF-8 bytes."""
    if isinstance(text, str):
        return text.encode("utf-8")
    if isinstance(text, np.ndarray):
        return text.astype(np.uint8).tobytes()
    return bytes(text)


def to_u8(text: TextLike) -> np.ndarray:
    """Canonicalize text-like input to an np.uint8 array."""
    if isinstance(text, np.ndarray):
        return np.ascontiguousarray(text, dtype=np.uint8)
    return np.frombuffer(to_bytes(text), dtype=np.uint8)


def num_code_units(cp: int) -> int:
    """UTF-8 encoded byte length of a code point."""
    if cp < 0x80:
        return 1
    if cp < 0x800:
        return 2
    if cp < 0x10000:
        return 3
    return 4


def is_trail_byte(b: int) -> bool:
    """True for UTF-8 continuation bytes (``Utf8.hs:276``)."""
    return (b & 0xC0) == 0x80


def decode_strict(data: bytes, idx: int) -> Tuple[int, int, bool]:
    """Strict streaming decode at ``idx``: ``(consumed, value, valid)``.

    ``valid`` only for the *minimal* encoding of a scalar value (no
    overlongs, no surrogates, max U+10FFFF) with all continuation bytes
    present — the WHATWG/UTF-8-standard acceptance ranges.  Anything else
    consumes exactly one byte with ``valid=False`` (the IgnoreCase paths
    pass such bytes through unchanged).  This single definition governs
    every IgnoreCase implementation (scalar oracle, vectorized and native
    transducers, and the composed case-folding DFA), so their lowered
    streams agree byte-for-byte on arbitrary input.  The reference never
    faces this choice: Haskell ``Text`` guarantees well-formed UTF-8
    (``Utf8.hs:17-19``).
    """
    b0 = data[idx]
    if b0 < 0x80:
        return 1, b0, True
    n = len(data)

    def tr(j):
        return j < n and 0x80 <= data[j] <= 0xBF

    if 0xC2 <= b0 <= 0xDF and tr(idx + 1):
        return 2, ((b0 & 0x1F) << 6) | (data[idx + 1] & 0x3F), True
    if 0xE0 <= b0 <= 0xEF and idx + 2 < n:
        d1 = data[idx + 1]
        lo, hi = (0xA0, 0xBF) if b0 == 0xE0 else (0x80, 0x9F) if b0 == 0xED else (0x80, 0xBF)
        if lo <= d1 <= hi and tr(idx + 2):
            return 3, ((b0 & 0x0F) << 12) | ((d1 & 0x3F) << 6) | (data[idx + 2] & 0x3F), True
    if 0xF0 <= b0 <= 0xF4 and idx + 3 < n:
        d1 = data[idx + 1]
        lo, hi = (0x90, 0xBF) if b0 == 0xF0 else (0x80, 0x8F) if b0 == 0xF4 else (0x80, 0xBF)
        if lo <= d1 <= hi and tr(idx + 2) and tr(idx + 3):
            return (
                4,
                ((b0 & 0x07) << 18)
                | ((d1 & 0x3F) << 12)
                | ((data[idx + 2] & 0x3F) << 6)
                | (data[idx + 3] & 0x3F),
                True,
            )
    return 1, b0, False


def lower_units_scalar(data: bytes) -> List[Tuple[int, int, bytes]]:
    """Scalar reference of the strict streaming lowerer: list of units
    ``(raw_start, raw_len, lowered_bytes)``.  Valid sequences lower through
    ``LOWER_TABLE`` and re-encode minimally; invalid bytes pass through.
    Used by tests as the ground truth for the vectorized / native / DFA
    implementations."""
    out = []
    i, n = 0, len(data)
    while i < n:
        consumed, v, valid = decode_strict(data, i)
        if valid:
            low = int(LOWER_TABLE[v])
            out.append((i, consumed, bytes(unicode2utf8(low))))
        else:
            out.append((i, 1, bytes([v])))
        i += consumed
    return out


def skip_code_points_backwards(text: TextLike, idx: int, n: int) -> int:
    """From byte ``idx``, move to the start of its code point, then skip ``n``
    more code points backwards; return the byte index of the resulting code
    point's first byte (``Utf8.hs:256-276``).

    Raises IndexError when reading out of bounds, matching the reference's
    bounds-checked behavior.
    """
    data = to_bytes(text)
    if idx >= len(data) or idx < 0:
        raise IndexError(f"skip_code_points_backwards: index {idx} out of bounds")
    while is_trail_byte(data[idx]):
        idx -= 1
        if idx < 0:
            raise IndexError("skip_code_points_backwards: ran past start of text")
    for _ in range(n):
        idx -= 1
        if idx < 0:
            raise IndexError("skip_code_points_backwards: ran past start of text")
        while is_trail_byte(data[idx]):
            idx -= 1
            if idx < 0:
                raise IndexError("skip_code_points_backwards: ran past start of text")
    return idx


def raw_match_starts(text: TextLike, ends: np.ndarray, lenc) -> np.ndarray:
    """Vectorized match-start recovery in raw coordinates: for each one-past-
    end byte index, skip back ``lenc`` code points and return the first byte
    of the landing code point (the reference's ``skipCodePointsBackwards``
    trick, ``Replacer.hs:264-274`` — an IgnoreCase match spans exactly the
    needle's code-point count in the haystack even when byte lengths differ
    under case folding).  ``lenc`` may be a scalar or a per-match array.

    Exact whenever every matched haystack unit is a valid UTF-8 sequence,
    which holds for whole-code-point needles (see ``models.case_dfa``):
    junk bytes before the match cannot shift the landing position.
    """
    ends = np.asarray(ends, dtype=np.int64)
    if len(ends) == 0:
        return ends.copy()
    lenc = np.broadcast_to(np.asarray(lenc, dtype=np.int64), ends.shape)
    if not lenc.any():
        return ends.copy()
    arr = to_u8(text)
    is_start = (arr & 0xC0) != 0x80
    pos = np.flatnonzero(is_start)
    ordinal = np.cumsum(is_start)  # 1-based cp ordinal at each byte
    starts = pos[ordinal[ends - 1] - np.maximum(lenc, 1)]
    # Zero-length matches (empty needle) start at their own end.
    return np.where(lenc == 0, ends, starts)


# ---------------------------------------------------------------------------
# Vectorized numpy codec (engine-facing)
# ---------------------------------------------------------------------------

# Byte length of the code point started by each possible lead byte; trail
# bytes map to 0 so they are easy to mask out.
_LEAD_LEN = np.zeros(256, dtype=np.int8)
_LEAD_LEN[0x00:0x80] = 1
_LEAD_LEN[0xC0:0xE0] = 2
_LEAD_LEN[0xE0:0xF0] = 3
_LEAD_LEN[0xF0:0xF9] = 4


def decode_utf8_np(arr: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized UTF-8 decode of a full valid byte array.

    Returns ``(code_points, starts, lens)`` where ``starts[i]`` is the byte
    offset of code point ``i`` and ``lens[i]`` its byte length.
    """
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    n = len(arr)
    if n == 0:
        z = np.zeros(0, dtype=np.int32)
        return z, z.copy(), z.copy()
    # numpy 2.x: fancy indexing by a uint8 index array is ~12x slower than
    # by int32 (np.take ~100x); widen indices first.
    lens_at = _LEAD_LEN[arr.astype(np.int32)]
    starts = np.flatnonzero(lens_at).astype(np.int32)
    lens = lens_at[starts].astype(np.int32)
    # Pad so unconditional gathers at starts+1..3 stay in bounds.
    padded = np.empty(n + 3, dtype=np.int32)
    padded[:n] = arr
    padded[n:] = 0
    b0 = padded[starts]
    b1 = padded[starts + 1] & 0x3F
    b2 = padded[starts + 2] & 0x3F
    b3 = padded[starts + 3] & 0x3F
    cps = np.where(
        lens == 1,
        b0,
        np.where(
            lens == 2,
            ((b0 & 0x1F) << 6) | b1,
            np.where(
                lens == 3,
                ((b0 & 0x0F) << 12) | (b1 << 6) | b2,
                ((b0 & 0x07) << 18) | (b1 << 12) | (b2 << 6) | b3,
            ),
        ),
    ).astype(np.int32)
    return cps, starts, lens


def encode_utf8_np(cps: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized UTF-8 encode. Returns ``(bytes_u8, out_lens_per_cp)``."""
    cps = np.ascontiguousarray(cps, dtype=np.int32)
    out_lens = np.where(cps < 0x80, 1, np.where(cps < 0x800, 2, np.where(cps < 0x10000, 3, 4))).astype(
        np.int32
    )
    offsets = np.zeros(len(cps), dtype=np.int64)
    np.cumsum(out_lens[:-1], out=offsets[1:]) if len(cps) > 1 else None
    total = int(out_lens.sum())
    out = np.zeros(total, dtype=np.uint8)

    l1 = out_lens == 1
    l2 = out_lens == 2
    l3 = out_lens == 3
    l4 = out_lens == 4
    # byte 0
    b0 = np.where(l1, cps, np.where(l2, 0xC0 | (cps >> 6), np.where(l3, 0xE0 | (cps >> 12), 0xF0 | (cps >> 18))))
    out[offsets] = b0.astype(np.uint8)
    # byte 1
    m = out_lens >= 2
    b1 = np.where(l2, 0x80 | (cps & 0x3F), np.where(l3, 0x80 | ((cps >> 6) & 0x3F), 0x80 | ((cps >> 12) & 0x3F)))
    out[offsets[m] + 1] = b1[m].astype(np.uint8)
    # byte 2
    m = out_lens >= 3
    b2 = np.where(l3, 0x80 | (cps & 0x3F), 0x80 | ((cps >> 6) & 0x3F))
    out[offsets[m] + 2] = b2[m].astype(np.uint8)
    # byte 3
    m = out_lens == 4
    out[offsets[m] + 3] = (0x80 | (cps[m] & 0x3F)).astype(np.uint8)
    return out, out_lens


def strict_units_np(arr: np.ndarray):
    """Vectorized strict streaming segmentation (see ``decode_strict``).

    Returns ``(starts, raw_lens, valid, cps)`` per unit.  Vectorization is
    possible because valid sequences are self-synchronizing: their interior
    bytes are continuations, which can never start a sequence — so every
    non-continuation byte starts a unit, and a continuation byte is its own
    (invalid, passthrough) unit exactly when the nearest preceding
    non-continuation byte's span does not cover it.
    """
    a = arr.astype(np.int32)
    n = len(a)
    if n == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z.copy(), np.zeros(0, dtype=bool), np.zeros(0, dtype=np.int32)
    pad = np.zeros(n + 3, np.int32)
    pad[:n] = a
    d1, d2, d3 = pad[1 : n + 1], pad[2 : n + 2], pad[3 : n + 3]
    t = (a & 0xC0) == 0x80
    t1 = (d1 & 0xC0) == 0x80
    t2 = (d2 & 0xC0) == 0x80
    t3 = (d3 & 0xC0) == 0x80
    v2 = (a >= 0xC2) & (a <= 0xDF) & t1
    v3 = (
        ((a == 0xE0) & (d1 >= 0xA0) & (d1 <= 0xBF))
        | ((a >= 0xE1) & (a <= 0xEC) & t1)
        | ((a == 0xED) & (d1 >= 0x80) & (d1 <= 0x9F))
        | ((a >= 0xEE) & (a <= 0xEF) & t1)
    ) & t2
    v4 = (
        ((a == 0xF0) & (d1 >= 0x90) & (d1 <= 0xBF))
        | ((a >= 0xF1) & (a <= 0xF3) & t1)
        | ((a == 0xF4) & (d1 >= 0x80) & (d1 <= 0x8F))
    ) & t2 & t3
    valid_at = (a < 0x80) | v2 | v3 | v4
    ln = np.where(
        a < 0x80, 1, np.where(v2, 2, np.where(v3, 3, np.where(v4, 4, 1)))
    ).astype(np.int64)
    idx = np.arange(n, dtype=np.int64)
    prev_nt = np.maximum.accumulate(np.where(~t, idx, -1))
    covered = (prev_nt >= 0) & (idx - prev_nt < ln[np.maximum(prev_nt, 0)])
    starts = np.flatnonzero(~t | ~covered).astype(np.int64)
    raw_lens = ln[starts]
    valid = valid_at[starts]
    b0 = a[starts]
    e1, e2, e3 = d1[starts] & 0x3F, d2[starts] & 0x3F, d3[starts] & 0x3F
    cps = np.where(
        raw_lens == 1,
        b0,
        np.where(
            raw_lens == 2,
            ((b0 & 0x1F) << 6) | e1,
            np.where(
                raw_lens == 3,
                ((b0 & 0x0F) << 12) | (e1 << 6) | e2,
                ((b0 & 0x07) << 18) | (e1 << 12) | (e2 << 6) | e3,
            ),
        ),
    ).astype(np.int32)
    return starts, raw_lens, valid, cps


def lower_units_np(arr: np.ndarray):
    """Vectorized strict streaming lowerer.

    Returns ``(lowered_bytes, starts, raw_lens, out_lens)`` — the primary
    (reference) implementation of the IgnoreCase byte-stream transducer;
    the native transducer and the composed case-folding DFA must agree
    byte-for-byte (tests pin all three against ``lower_units_scalar``).
    """
    starts, raw_lens, valid, cps = strict_units_np(arr)
    low = np.where(valid, LOWER_TABLE[np.where(valid, cps, 0)], cps)
    out_lens = np.where(
        ~valid,
        1,
        np.where(low < 0x80, 1, np.where(low < 0x800, 2, np.where(low < 0x10000, 3, 4))),
    ).astype(np.int64)
    m = len(starts)
    offsets = np.zeros(m, dtype=np.int64)
    if m > 1:
        np.cumsum(out_lens[:-1], out=offsets[1:])
    out = np.zeros(int(out_lens.sum()), dtype=np.uint8)
    l1 = out_lens == 1
    l2 = out_lens == 2
    l3 = out_lens == 3
    b0 = np.where(
        l1,
        low,  # ASCII lowered value, or the invalid byte passed through
        np.where(l2, 0xC0 | (low >> 6), np.where(l3, 0xE0 | (low >> 12), 0xF0 | (low >> 18))),
    )
    out[offsets] = b0.astype(np.uint8)
    sel = out_lens >= 2
    b1 = np.where(l2, 0x80 | (low & 0x3F), np.where(l3, 0x80 | ((low >> 6) & 0x3F), 0x80 | ((low >> 12) & 0x3F)))
    out[offsets[sel] + 1] = b1[sel].astype(np.uint8)
    sel = out_lens >= 3
    b2 = np.where(l3, 0x80 | (low & 0x3F), 0x80 | ((low >> 6) & 0x3F))
    out[offsets[sel] + 2] = b2[sel].astype(np.uint8)
    sel = out_lens == 4
    out[offsets[sel] + 3] = (0x80 | (low[sel] & 0x3F)).astype(np.uint8)
    return out, starts, raw_lens, out_lens


class LoweredText:
    """A lowercased byte stream annotated with raw-byte coordinates.

    IgnoreCase engines match on ``lowered`` but must report positions in the
    *raw* haystack's byte coordinates (the reference achieves this by decoding
    code-point-wise on the fly and counting raw code units,
    ``AhoCorasick/Automaton.hs:468-480``; we lower up front and carry maps).

    Attributes (materialized lazily — the common pure-ASCII case is an
    identity mapping and never allocates them; use the ``map_ends_to_raw`` /
    ``cp_of_raw_end`` / ``raw_start_of_cp`` methods where possible):

      lowered:   np.uint8 lowered byte stream (byte lengths may differ from raw!)
      cp_index:  np.int32 per lowered byte: index of the code point it encodes
      raw_start: np.int32 per code point: raw byte offset of its first raw byte
      raw_end:   np.int32 per code point: raw byte offset one past its last raw byte
    """

    def __init__(
        self,
        lowered: np.ndarray,
        cp_index: np.ndarray = None,
        raw_start: np.ndarray = None,
        raw_end: np.ndarray = None,
        *,
        identity: bool = False,
        out_lens: np.ndarray = None,
        raw_len: np.ndarray = None,
    ):
        self.lowered = lowered
        self._identity = identity
        self._cp_index = cp_index
        self._raw_start = raw_start
        self._raw_end = raw_end
        self._raw_len = raw_len  # [n_cps] raw byte length per cp (raw_end alt)
        self._out_lens = out_lens  # [n_cps] lowered byte length per cp
        self._out_starts = None

    @property
    def identity(self) -> bool:
        """True when lowered byte i corresponds 1:1 to raw byte i."""
        return self._identity

    @property
    def cp_index(self) -> np.ndarray:
        if self._cp_index is None:
            if self._identity:
                self._cp_index = np.arange(len(self.lowered), dtype=np.int32)
            else:
                self._cp_index = np.repeat(
                    np.arange(len(self._out_lens), dtype=np.int32), self._out_lens
                )
        return self._cp_index

    @property
    def raw_start(self) -> np.ndarray:
        if self._raw_start is None and self._identity:
            self._raw_start = np.arange(len(self.lowered), dtype=np.int32)
        return self._raw_start

    @property
    def raw_end(self) -> np.ndarray:
        if self._raw_end is None:
            if self._identity:
                self._raw_end = np.arange(1, len(self.lowered) + 1, dtype=np.int32)
            elif self._raw_len is not None:
                self._raw_end = self._raw_start + self._raw_len
        return self._raw_end

    def _lowered_cp_starts(self) -> np.ndarray:
        """Lowered byte offset at which each code point starts."""
        if self._out_starts is None:
            starts = np.zeros(len(self._out_lens) + 1, dtype=np.int64)
            np.cumsum(self._out_lens, out=starts[1:])
            self._out_starts = starts[:-1]
        return self._out_starts

    def cp_of_lowered(self, lowered_pos) -> np.ndarray:
        """Code point index covering each lowered byte position (sparse)."""
        if self._identity:
            return np.asarray(lowered_pos, dtype=np.int64)
        if self._cp_index is not None:
            return self._cp_index[lowered_pos].astype(np.int64)
        return (
            np.searchsorted(self._lowered_cp_starts(), lowered_pos, side="right") - 1
        )

    def map_ends_to_raw(self, lowered_ends) -> np.ndarray:
        """Lowered-coords match ends (one past last byte) -> raw coords."""
        if self._identity:
            return np.asarray(lowered_ends, dtype=np.int64)
        return self.raw_end[self.cp_of_lowered(np.asarray(lowered_ends) - 1)].astype(
            np.int64
        )

    def cp_of_raw_end(self, raw_ends) -> np.ndarray:
        """Index of the code point whose raw encoding ends at raw_ends."""
        if self._identity:
            return np.asarray(raw_ends, dtype=np.int64) - 1
        return np.searchsorted(self.raw_end, raw_ends, side="left")

    def raw_start_of_cp(self, cp_idx) -> np.ndarray:
        if self._identity:
            return np.asarray(cp_idx, dtype=np.int64)
        return self.raw_start[cp_idx].astype(np.int64)

    @property
    def n_code_points(self) -> int:
        if self._identity:
            return len(self.lowered)
        if self._out_lens is not None:
            return len(self._out_lens)
        return len(self.raw_start)

    def match_raw_end(self, lowered_end: int) -> int:
        """Map a lowered-coords match end (one past last byte) to raw coords."""
        return int(self.raw_end[self.cp_index[lowered_end - 1]])

    def match_raw_start_by_cp_len(self, lowered_end: int, needle_cp_len: int) -> int:
        """Raw byte offset of the match start, given the needle's length in
        code points — the coordinate the reference recovers via
        ``skipCodePointsBackwards`` (``Replacer.hs:264-274``)."""
        end_cp = int(self.cp_index[lowered_end - 1])
        start_cp = end_cp - (needle_cp_len - 1)
        return int(self.raw_start[start_cp])


_NATIVE_LIB = None
_NATIVE_TRIED = False

# Grow-only scratch buffers for the native transducer calls: reusing them
# avoids first-touch page faults of per-call allocations on large inputs.
_SCRATCH: dict = {}
_SCRATCH_LOCK = _threading.Lock()


def _scratch(key: str, size: int, dtype) -> np.ndarray:
    buf = _SCRATCH.get(key)
    if buf is None or len(buf) < size:
        buf = np.empty(int(size * 5 // 4) + 16, dtype=dtype)
        _SCRATCH[key] = buf
    return buf


def _native_lib():
    """The port's host C++ library, or None (no toolchain, or
    ``AMT_NO_NATIVE`` set)."""
    global _NATIVE_LIB, _NATIVE_TRIED
    if not _NATIVE_TRIED:
        _NATIVE_TRIED = True
        if os.environ.get("AMT_NO_NATIVE"):
            return None
        try:
            from ..native import build as _native_build

            _NATIVE_LIB = _native_build.load()
        except Exception:
            _NATIVE_LIB = None
    return _NATIVE_LIB


_LOWER_EMAP = None


def _lower_encode_map() -> np.ndarray:
    """uint64 [0x10000]: per BMP code point, its LOWERED UTF-8 encoding —
    output width in the top byte, encoded bytes little-endian below (the
    branchless emit table of the native ``am_lower_bytes``).  Simple
    lowercase maps BMP into BMP, so 3 encoded bytes always suffice."""
    global _LOWER_EMAP
    if _LOWER_EMAP is None:
        low = LOWER_TABLE[:0x10000].astype(np.int64)
        w = np.where(low < 0x80, 1, np.where(low < 0x800, 2, 3)).astype(np.int64)
        b0 = np.where(
            w == 1, low, np.where(w == 2, 0xC0 | (low >> 6), 0xE0 | (low >> 12))
        )
        b1 = np.where(
            w == 1, 0, np.where(w == 2, 0x80 | (low & 0x3F), 0x80 | ((low >> 6) & 0x3F))
        )
        b2 = np.where(w == 3, 0x80 | (low & 0x3F), 0)
        _LOWER_EMAP = ((w << 56) | b0 | (b1 << 8) | (b2 << 16)).astype(np.uint64)
    return _LOWER_EMAP


def lower_transform(text: TextLike, need_coords: bool = True) -> LoweredText:
    """Lowercase a UTF-8 byte stream, carrying raw coordinates.

    ASCII-only inputs take a pure byte-LUT fast path; otherwise the stream is
    decoded, mapped through the frozen simple-lowercase table, and re-encoded
    (byte lengths can shrink — İ 2B→i 1B — or grow — Ⱥ 2B→ⱥ 3B).

    ``need_coords=False`` skips the per-code-point raw-coordinate arrays
    (~3x the work and memory): counting and existence queries never map
    positions back, and the coordinate arrays dominate the transducer's
    cost on this host (fresh-page faults).
    """
    arr = to_u8(text)
    n = len(arr)
    lib = _native_lib()
    if lib is not None and n:
        arr_c = np.ascontiguousarray(arr)
        if lib.am_is_ascii(arr_c.ctypes.data, n):
            out = np.empty(n, dtype=np.uint8)
            lib.am_lower_ascii(arr_c.ctypes.data, n, out.ctypes.data)
            return LoweredText(lowered=out, identity=True)
        if not need_coords:
            cap = n + n // 2 + 16
            emap = _lower_encode_map()
            with _SCRATCH_LOCK:
                while True:
                    out = _scratch("lb_out", cap, np.uint8)
                    out_nbytes = np.zeros(1, dtype=np.int64)
                    status = int(
                        lib.am_lower_bytes(
                            LOWER_TABLE.ctypes.data,
                            emap.ctypes.data,
                            arr_c.ctypes.data,
                            n,
                            out.ctypes.data,
                            cap,
                            out_nbytes.ctypes.data,
                        )
                    )
                    if status == 0:
                        break
                    cap = 4 * n + 16  # malformed input can exceed the 1.5x bound
                return LoweredText(lowered=out[: int(out_nbytes[0])].copy())
        cap = n + n // 2 + 16
        with _SCRATCH_LOCK:
            while True:
                out = _scratch("lt_out", cap, np.uint8)
                raw_start = _scratch("lt_rs", n, np.int32)
                raw_len = _scratch("lt_rl", n, np.int32)
                out_len = _scratch("lt_ol", n, np.int32)
                out_nbytes = np.zeros(1, dtype=np.int64)
                n_cps = int(
                    lib.am_lower_transform(
                        LOWER_TABLE.ctypes.data,
                        _lower_encode_map().ctypes.data,
                        arr_c.ctypes.data,
                        n,
                        out.ctypes.data,
                        cap,
                        raw_start.ctypes.data,
                        raw_len.ctypes.data,
                        out_len.ctypes.data,
                        out_nbytes.ctypes.data,
                    )
                )
                if n_cps >= 0:
                    break
                cap = 4 * n + 16  # malformed input can exceed the 1.5x bound
            return LoweredText(
                lowered=out[: int(out_nbytes[0])].copy(),
                raw_start=raw_start[:n_cps].copy(),
                raw_len=raw_len[:n_cps].astype(np.int8),
                out_lens=out_len[:n_cps].astype(np.int8),
            )
    if n == 0 or int(arr.max(initial=0)) < 0x80:
        return LoweredText(lowered=ASCII_LOWER_BYTES[arr.astype(np.int32)], identity=True)
    lowered, starts, raw_lens, out_lens = lower_units_np(arr)
    return LoweredText(
        lowered=lowered,
        raw_start=starts.astype(np.int32),
        raw_end=(starts + raw_lens).astype(np.int32),
        out_lens=out_lens,
    )


__all__ = [
    "ASCII_LOWER_BYTES",
    "LOWER_TABLE",
    "MAX_CP",
    "LoweredText",
    "TextLike",
    "decode_strict",
    "decode_utf8_np",
    "encode_utf8_np",
    "lower_code_point",
    "lower_str",
    "lower_transform",
    "lower_units_np",
    "lower_units_scalar",
    "raw_match_starts",
    "skip_code_points_backwards",
    "strict_units_np",
    "to_bytes",
    "to_u8",
    "unicode2utf8",
    "unlower_code_point",
]
