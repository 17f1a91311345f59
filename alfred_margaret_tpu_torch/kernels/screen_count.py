"""``screen_count``: the count of a needle set by a suffix screen and exact
verification, the grouped engine's count wherever the needle set allows it.

Wrapper of ``csrc/screen_count.cu``, a kernel written for the H100 that
replaces no TPU kernel: the grouped tier's fused automaton count (B9,
``kernels/comb16_grouped.py``) steps every group on every byte, where this
kernel tests the last ``key_bytes`` bytes at each step against a bitmap of the
needles' keys and compares the rare candidates exactly (the source's note
says why).  A CUDA tensor launches the kernel; a CPU tensor runs the plain
torch version.  Nothing falls back from one to the other.

:func:`plan_screen` builds the tables from a machine, or returns None where
the set does not suit the screen: a composed case-folding machine (its
needles are not the bytes it matches), a needle under
:data:`MIN_NEEDLE_BYTES` or over :data:`MAX_NEEDLE_BYTES`, or more than
:data:`MAX_BUCKET` distinct needles sharing a key.  The count is the
automaton's: every (needle, end) pair, a needle given twice counted twice,
nested and overlapping needles each counted.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass
from typing import Optional

import torch

from .common import check_overlap, check_streams, check_tables, launch, on_cpu
from .segments import BLOCK_STREAMS, T_TILE, Design, pick_segments, sm_count

#: The shortest needle the screen takes.  On an H100, 50 needles of three
#: letters beside config 5's first 1,000 (a 3-byte key) pass the screen at
#: ten times as many positions as 50 of four, and the count takes 1.85x as
#: long (``PERF.md`` section 6): a shorter key screens little.
MIN_NEEDLE_BYTES = 4
#: The longest: the history a thread keeps, four 32-bit words.  Needles of
#: 12 to 16 bytes beside config 5's cost nothing measurable (section 6).
MAX_NEEDLE_BYTES = 16
#: The most distinct needles that may share a key: a pass compares each of
#: them.  Where half the words of a text end in one shared key, 8 such
#: needles take 1.9x the time of 1, 32 take 4.3x (section 6).
MAX_BUCKET = 8
#: The largest bitmap, in bits: fastest of 2^14 to 2^18 for config 5's
#: first 1,000 needles on an H100 (section 6).  A smaller set takes the
#: fewest bits that give each key ``KEY_LOAD`` bits or more, as those 1,000
#: have in 2^17.
BITMAP_BITS = 17
KEY_LOAD = 128
MIN_BITMAP_BITS = 10
#: The multiplicative hash of ``csrc/screen_count.cu`` (kHashA, kHashB).
HASH_A = 0x9E3779B1
HASH_B = 0x85EBCA77
_M32 = 0xFFFFFFFF


def _mask(nb: int) -> int:
    return _M32 if nb >= 4 else (0 if nb <= 0 else (1 << (8 * nb)) - 1)


def _hash(k0: int, k1: int) -> int:
    return ((((k1 * HASH_B) & _M32) ^ k0) * HASH_A) & _M32


def _probe(h, bits: int):
    """The bitmap's word and the mask of the two bits a key of hash ``h``
    sets and a step tests (ints, or int64 tensors)."""
    ws = 37 - bits  # the hash's top bits - 5 bits pick the word
    return h >> ws, (1 << ((h >> (ws - 5)) & 31)) | (1 << ((h >> (ws - 10)) & 31))


def _words(needle: bytes):
    """The needle's four history words: its last byte in the low 8 bits of
    the first, bytes past its length zero."""
    v = int.from_bytes(needle[::-1], "little")  # the last byte lowest
    return [(v >> (32 * i)) & _M32 for i in range(4)]


@dataclass
class ScreenTables:
    """The screen's tables on one device: ``bitmap`` int32 ``[2**bits //
    32]``, two bits of one word a key; ``slots`` int32 ``[2**slot_bits,
    4]`` (the key's two words, its first record, its number of records; 0
    records: empty); ``recs`` int32
    ``[n, 8]`` (the needle's four words, its length, its multiplicity, 0, 0),
    one a distinct needle, grouped by key; ``passes`` int64 ``[1]``, the
    screen passes the kernel (or the plain version) adds to."""

    bitmap: torch.Tensor
    slots: torch.Tensor
    recs: torch.Tensor
    passes: torch.Tensor
    bits: int
    slot_bits: int
    key_bytes: int
    max_bytes: int

    def check_overlap(self, overlap) -> None:
        """Raise ``ValueError`` for a segment warm-up under the longest
        needle less one: a needle across a cut would be lost."""
        if overlap is not None and overlap < self.max_bytes - 1:
            raise ValueError(f"overlap {overlap} is under the screen's longest needle "
                             f"less one ({self.max_bytes - 1})")


def plan_screen(machine, device) -> Optional[ScreenTables]:
    """The screen's tables for ``machine`` on ``device``, or None where the
    set does not suit it (the module's note)."""
    needles = machine.needles
    if getattr(machine, "composed_ci", False) or not needles:
        return None
    if not all(MIN_NEEDLE_BYTES <= len(n) <= MAX_NEEDLE_BYTES for n in needles):
        return None
    mult = collections.Counter(needles)
    key_bytes = min(8, min(len(n) for n in mult))
    buckets = collections.defaultdict(list)
    for n in mult:  # first occurrences, in order
        w = _words(n)
        buckets[(w[0] & _mask(key_bytes), w[1] & _mask(key_bytes - 4))].append(n)
    if max(len(b) for b in buckets.values()) > MAX_BUCKET:
        return None
    n_keys = len(buckets)
    bits = max(MIN_BITMAP_BITS, min(BITMAP_BITS, (KEY_LOAD * n_keys - 1).bit_length()))
    slot_bits = max(1, (2 * n_keys - 1).bit_length())
    bitmap = [0] * ((1 << bits) // 32)
    slots = [[0, 0, 0, 0] for _ in range(1 << slot_bits)]
    recs = []
    for (k0, k1), group in buckets.items():
        h = _hash(k0, k1)
        word, m = _probe(h, bits)
        bitmap[word] |= m
        slot = h >> (32 - slot_bits)
        while slots[slot][3]:
            slot = (slot + 1) & ((1 << slot_bits) - 1)
        slots[slot] = [k0, k1, len(recs), len(group)]
        recs += [[*_words(n), len(n), mult[n], 0, 0] for n in group]

    def i32(rows):
        return torch.tensor(rows, dtype=torch.int64).to(torch.int32).to(device).contiguous()

    return ScreenTables(
        bitmap=i32(bitmap), slots=i32(slots), recs=i32(recs),
        passes=torch.zeros(1, dtype=torch.int64, device=device), bits=bits,
        slot_bits=slot_bits, key_bytes=key_bytes, max_bytes=max(len(n) for n in mult))


def _check(streams, tables: ScreenTables, **vectors) -> None:
    _, S = check_streams(streams)
    if not MIN_BITMAP_BITS <= tables.bits <= 20 or not 1 <= tables.slot_bits <= 24:
        raise ValueError(f"bitmap of 2**{tables.bits} bits, 2**{tables.slot_bits} slots")
    if not 1 <= tables.key_bytes <= 8 or tables.recs.dim() != 2:
        raise ValueError(f"key of {tables.key_bytes} bytes, records {tuple(tables.recs.shape)}")
    if tables.passes.dtype != torch.int64 or tables.passes.shape != (1,) \
            or tables.passes.device != streams.device:
        raise ValueError("passes must be one int64 on the streams' device")
    check_tables(streams.device, {
        "bitmap": (tables.bitmap, ((1 << tables.bits) // 32,)),
        "slots": (tables.slots, (1 << tables.slot_bits, 4)),
        "recs": (tables.recs, (tables.recs.shape[0], 8)),
        **{name: (x, (S,)) for name, x in vectors.items()},
    })


def _mul32(x, c: int):
    """``x * c mod 2**32`` for int64 ``x`` in [0, 2**32), without overflow."""
    return ((x & 0xFFFF) * c + ((((x >> 16) * c) & 0xFFFF) << 16)) & _M32


def screen_count_plain(streams, warm, vend, tables: ScreenTables, overlap=None):
    """Plain torch version of ``screen_count``: every step's four history
    words at once (zero before step 0), the key's hash and two bits, then each
    screen pass at a step ``warm <= t < vend`` verified as the kernel does,
    with ``t + 1`` bytes read.  Adds the passes to ``tables.passes``.
    (``overlap`` only lets the kernel cut the streams into segments.)"""
    T, S = streams.shape
    dev = streams.device
    pad = torch.cat([torch.zeros(15, S, dtype=torch.int64, device=dev), streams.long()])
    w = []
    for i in range(4):
        x = torch.zeros(T, S, dtype=torch.int64, device=dev)
        for j in range(4):
            d = 4 * i + j  # bytes back
            x |= pad[15 - d:15 - d + T] << (8 * j)
        w.append(x)
    k0, k1 = w[0] & _mask(tables.key_bytes), w[1] & _mask(tables.key_bytes - 4)
    h = _mul32(_mul32(k1, HASH_B) ^ k0, HASH_A)
    word, m = _probe(h, tables.bits)
    word = tables.bitmap.long()[word] & _M32
    t = torch.arange(T, dtype=torch.int64, device=dev).unsqueeze(1)
    live = (t >= warm.long().unsqueeze(0)) & (t < vend.long().unsqueeze(0))
    ts, ss = torch.nonzero((word & m == m) & live, as_tuple=True)
    counts = torch.zeros(S, dtype=torch.int64)
    slots = [[v & _M32 for v in row] for row in tables.slots.tolist()]
    recs = [[v & _M32 for v in row] for row in tables.recs.tolist()]
    smask, sshift = (1 << tables.slot_bits) - 1, 32 - tables.slot_bits
    cand = torch.stack([ts, ss, k0[ts, ss], k1[ts, ss], h[ts, ss],
                        *(x[ts, ss] for x in w)], 1).tolist() if len(ts) else []
    for t_, s_, a, b, hv, *hist in cand:
        slot = hv >> sshift
        while slots[slot][3]:
            e = slots[slot]
            if e[0] == a and e[1] == b:
                for r in recs[e[2]:e[2] + e[3]]:
                    L = r[4]
                    if L <= t_ + 1 and all((hist[i] ^ r[i]) & _mask(L - 4 * i) == 0
                                           for i in range(4)):
                        counts[s_] += r[5]
                break
            slot = (slot + 1) & smask
    tables.passes += len(cand)
    return counts.to(torch.int32).to(dev)


def screen_smem_bytes(bits: int) -> int:
    """The kernel's dynamic shared memory: two staged tiles and the bitmap."""
    return 2 * T_TILE * BLOCK_STREAMS + (1 << bits) // 8


def screen_count_design(streams, tables: ScreenTables, overlap=None) -> Design:
    """The segments ``screen_count`` launches with for these CUDA streams."""
    T, S = streams.shape
    return Design(pick_segments(S, T, overlap, screen_smem_bytes(tables.bits),
                                sm_count(streams.device)))


def screen_count(streams, warm, vend, tables: ScreenTables, overlap=None):
    """int32 [S]: per stream of ``streams`` ([T, S] uint8), the matches of
    the needle set of ``tables`` (a :class:`ScreenTables`) ending at t in
    [warm[s], vend[s]), each distinct needle counted with its multiplicity;
    the screen passes added to ``tables.passes``.  With the stream plan's
    ``overlap`` (at least the longest needle less one) the kernel may cut
    each stream into segments (``kernels/segments.py:run_segments``)."""
    _check(streams, tables, warm=warm, vend=vend)
    check_overlap(overlap)
    tables.check_overlap(overlap)
    if on_cpu(streams):
        return screen_count_plain(streams, warm, vend, tables)
    T, S = streams.shape
    d = screen_count_design(streams, tables, overlap)
    out = torch.zeros(S, dtype=torch.int32, device=streams.device)
    launch(
        "amt_screen_count", streams.device,
        streams.data_ptr(), T, S, warm.data_ptr(), vend.data_ptr(), tables.bitmap.data_ptr(),
        tables.bits, tables.slots.data_ptr(), tables.slot_bits, tables.recs.data_ptr(),
        tables.key_bytes, overlap or 0, d.segments, out.data_ptr(), tables.passes.data_ptr(),
    )
    screen_count.launches += 1
    return out


#: Kernel launches since the last reset (CPU calls do not count).
screen_count.launches = 0

__all__ = [
    "BITMAP_BITS",
    "MAX_BUCKET",
    "MAX_NEEDLE_BYTES",
    "MIN_NEEDLE_BYTES",
    "ScreenTables",
    "plan_screen",
    "screen_count",
    "screen_count_design",
    "screen_count_plain",
    "screen_smem_bytes",
]
