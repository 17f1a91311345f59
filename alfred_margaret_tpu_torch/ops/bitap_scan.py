"""Bitap (shift-AND) engine over the hand-written CUDA kernels B2, B4, B6
and B7, CaseSensitive and IgnoreCase.

Counterpart of ``alfred_margaret_tpu/ops/bitap_scan.py``: ``WordLayout``,
``BitapLayout``, ``_pack_words``, ``_plan_tracks``, ``plan_bitap``,
``plan_bitap_ci``, ``make_host_exact`` and ``host_stream_count`` are copied
as numpy (that module imports ``jax``; ``tests/test_torch_layout.py`` and
``tests/test_torch_case.py`` pin the copies to the originals), and
``BitapAcEngine`` takes the place of the JAX ``BitapAcEngine`` for counting
(B2), containsAny (B4), per-needle presence for containsAll (B7) and,
through the dense engine's extraction path, the one-word bitap step of the
hit bitmap (B6).

Every unique needle is one bit track in an int32 register; a stream steps
``D = ((D << 1) | SEED) & B[byte]`` and each track's end bit counts its
needle, weighted by how often the needle occurs in the needle list.  So
overlapping matches, suffix needles and duplicate needles count exactly as
the Aho-Corasick machine counts them.

IgnoreCase (``plan_bitap_ci``, on a composed case-folding machine): each
track position accepts the byte set of its code point's same-length
unlowerings, and trap tracks watch for the length-changing ones (İ, Kelvin
K, Å, ẞ, ...), in the spare high bits of the match words or in a standalone
trap register.  The kernels' trap parts return a per-stream trap flag; a
stream whose flag is set may under-count, so the engine re-counts those
streams on the host from the raw corpus, or, above ``TRAP_LOCAL_FRAC`` of
the live streams or without a host corpus, re-scans with the dense kernels
on the composed machine (B1, B3), as the JAX engine does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels.bitap_contains import bitap_contains, bitap_presence
from ..kernels.bitap_count import bitap_count, bitap_count_plain
from ..kernels.dense_contains import dense_contains
from ..kernels.dense_count import dense_count
from ..models import ac
from ..models.ac import AcMachine
from ..models.byteclass import ci_track_key, ci_tracks
from ..native.build import NativeUnavailable
from ..native.cpp_engine import CppAcEngine
from ..utils import trace
from .pallas_scan import DenseAcEngine, StagedStreams, sum_live

#: Track budget: bit 31 stays clear (the int32 sign), and the last count
#: field needs headroom toward bit 30.
MAX_TRACK_BITS = 30


@dataclass(frozen=True)
class WordLayout:
    """Track layout for ONE int32 bitap register (word)."""

    seed: int  # bit per track start, injected every step
    endmask: int  # bit per track end (match flag)
    btab: np.ndarray  # int64 [256] byte -> track mask
    #: per track: (end_bit, headroom_bits, multiplicity_weight)
    fields: Tuple[Tuple[int, int, int], ...]
    #: per track: canonical needle key (CS: the needle bytes; CI: the
    #: lowered-needle bytes), aligned with ``fields``
    keys: Tuple[bytes, ...] = ()
    #: end bits of EMBEDDED trap tracks riding this word's register in the
    #: spare bits above the last count field's flush headroom: trap
    #: detection then costs no extra register.  Their seed/btab bits are
    #: already merged into ``seed``/``btab``; they are absent from
    #: ``fields`` so counts never see them.
    trap_endmask: int = 0

    @property
    def fold(self) -> bool:
        """True when bytes >= 127 share one mask (ASCII needles): the TPU
        kernel's one-row lookup mode.  The port's kernels read the whole
        256-entry table, so only the parity tests read this."""
        return bool((self.btab[127:] == self.btab[127]).all())


@dataclass(frozen=True)
class BitapLayout:
    """Multi-word track layout: needles bin-packed into ``V`` int32
    registers per stream.  Per byte the kernel does V independent mask
    lookups and about 3V dependent ALU operations; the dispatcher caps V
    (``ops.comb_scan.BITAP_MAX_WORDS``)."""

    words: Tuple[WordLayout, ...]
    unroll: int  # flush block size (2**min_headroom > unroll, every field)
    #: IgnoreCase trap register: sticky tracks for the length-changing
    #: unlowering encodings excluded from the byte-class tracks; a hit
    #: means the bitap result may under-count and the caller must recover
    #: (host re-count or the composed dense kernel).  None = tracks are
    #: exact alone.
    trap: Optional[WordLayout] = None
    #: True for byte-class (composed IgnoreCase) layouts.
    ci: bool = False

    @property
    def n_words(self) -> int:
        return len(self.words)

    @property
    def has_trap(self) -> bool:
        """True when ANY trap tracks exist (embedded in match words or in
        the standalone trap register): the kernels then emit the sticky
        trap plane and callers must honor the fallback contract."""
        return self.trap is not None or any(w.trap_endmask for w in self.words)

    def all_words(self) -> Tuple[WordLayout, ...]:
        """Match words + the trap word (if any), in kernel B-table order."""
        return self.words + ((self.trap,) if self.trap is not None else ())


#: A track: per-position accepted byte sets, a count weight, and the
#: canonical needle key.  CaseSensitive needles are singleton-set tracks.
_Track = Tuple[Tuple[Tuple[int, ...], ...], int, bytes]


def _pack_words(tracks: Sequence[_Track], min_head: int):
    """Greedy sequential packing of ascending-length tracks into 30-bit
    words (tracks never span words; the shortest track of each word goes
    first so later tracks' lengths double as count-field headroom)."""
    words = []
    i = 0
    while i < len(tracks):
        seed = 0
        endmask = 0
        btab = np.zeros(256, dtype=np.int64)
        fields = []
        keys = []
        off = 0
        took = 0
        while i < len(tracks):
            possets, weight, key = tracks[i]
            tlen = len(possets)
            end = off + tlen - 1
            # A track may turn out to be the last in its word, so it must
            # leave min_head bits of final headroom; close the word early
            # and spill to the next one otherwise.
            if MAX_TRACK_BITS - end < min_head:
                break
            seed |= 1 << off
            for pp, bset in enumerate(possets):
                for b in bset:
                    btab[b] |= 1 << (off + pp)
            endmask |= 1 << end
            fields.append([end, MAX_TRACK_BITS - end, weight])
            keys.append(key)
            if len(fields) > 1:
                fields[-2][1] = end - fields[-2][0]
            took += 1
            i += 1
            if i < len(tracks):
                nlen = len(tracks[i][0])
                head = max(nlen, min_head)
                off = end + 1 + (head - nlen)  # guard bits
        if took == 0:
            return None  # single track longer than a word
        assert all(h >= min_head for _, h, _ in fields)
        words.append(
            WordLayout(
                seed=seed,
                endmask=endmask,
                btab=btab,
                fields=tuple((e, h, w) for e, h, w in fields),
                keys=tuple(keys),
            )
        )
    return tuple(words)


def _plan_tracks(
    tracks: Sequence[_Track],
    max_unroll: int,
    max_words: int,
    trap: Optional[WordLayout] = None,
    ci: bool = False,
) -> Optional[BitapLayout]:
    """The largest flush block (power of two <= ``max_unroll``) that every
    count field can absorb without carry overflow; None when even
    single-byte flush blocks cannot fit."""
    if sum(len(t[0]) for t in tracks) > max_words * MAX_TRACK_BITS:
        return None
    tracks = sorted(tracks, key=lambda t: len(t[0]))
    unroll = max_unroll
    while unroll >= 1:
        min_head = max(1, int(unroll).bit_length())  # unroll < 2**min_head
        words = _pack_words(tracks, min_head)
        if words is not None and len(words) <= max_words:
            return BitapLayout(words=words, unroll=unroll, trap=trap, ci=ci)
        unroll //= 2
    return None


def plan_bitap(
    machine: AcMachine, max_unroll: int = 8, max_words: int = 3
) -> Optional[BitapLayout]:
    """Track layout for ``machine``'s needles, or None if ineligible: a
    composed IgnoreCase machine, an empty needle list, an empty needle or a
    NUL byte (pad bytes must clear the registers), or more track bytes than
    ``max_words`` registers hold.  Duplicate needles share one track whose
    weight is their multiplicity."""
    if getattr(machine, "composed_ci", False):
        return None
    if not machine.needles:
        return None
    mult: Dict[bytes, int] = {}
    for nd in machine.needles:
        if len(nd) == 0 or 0 in nd:
            return None  # empty needle (root piggyback) / NUL (pad bytes)
        mult[bytes(nd)] = mult.get(bytes(nd), 0) + 1
    tracks = [
        (tuple((b,) for b in nd), w, nd) for nd, w in mult.items()
    ]
    return _plan_tracks(tracks, max_unroll, max_words)


def plan_bitap_ci(
    machine: AcMachine, max_unroll: int = 8, max_words: int = 3
) -> Optional[BitapLayout]:
    """Byte-class track layout for a composed case-folding DFA, or None.

    One track per unique *lowered* needle (original-case duplicates fold
    into the multiplicity weight: ``Foo`` and ``foo`` are the same CI
    emission stream, matching the composed DFA's per-state counts); each
    track position accepts the union of that code point's same-length
    unlowering bytes, with the closure gate of :func:`_ci_cp_sets`.
    Length-changing unlowerings pack into the sticky trap word.
    """
    got = ci_tracks(machine)
    if got is None:
        return None
    tracks, trap_list = got

    lay0 = _plan_tracks(tracks, max_unroll, max_words, ci=True)
    if lay0 is None or not trap_list:
        return lay0

    # Embed trap tracks into the spare trailing bits of the match words
    # (above each last field's flush headroom): detection then rides the
    # SAME register, where the standalone trap word costs one more register
    # and mask lookup per byte.  Trap
    # end bits live in `trap_endmask`, never in `fields`, so counts are
    # untouched; back-to-back placement is safe for the same reason match
    # tracks pack tightly (the seed re-injects the start bit every step,
    # so a neighbor's leaked carry bit is indistinguishable from the
    # seed).  Whatever does not fit spills to the standalone register.
    min_head = max(1, int(lay0.unroll).bit_length())
    remaining = sorted(trap_list, key=len)
    new_words = []
    for wl in lay0.words:
        seed, btab, tem = wl.seed, wl.btab.copy(), 0
        off = max(e for e, _, _ in wl.fields) + min_head
        still = []
        for enc in remaining:
            if off + len(enc) - 1 <= MAX_TRACK_BITS - 1:
                seed |= 1 << off
                for p, b in enumerate(enc):
                    btab[b] |= 1 << (off + p)
                tem |= 1 << (off + len(enc) - 1)
                off += len(enc)
            else:
                still.append(enc)
        remaining = still
        new_words.append(
            WordLayout(
                seed=seed,
                endmask=wl.endmask,
                btab=btab,
                fields=wl.fields,
                keys=wl.keys,
                trap_endmask=tem,
            )
        )
    trap = None
    if remaining:
        packed = _pack_words(
            [(tuple((b,) for b in e), 0, e) for e in remaining], 1
        )
        if packed is None or len(packed) != 1:
            return None  # absurd needle set: too many distinct trap letters
        trap = packed[0]
    return BitapLayout(
        words=tuple(new_words), unroll=lay0.unroll, trap=trap, ci=True
    )


def longest_track(lay: BitapLayout) -> int:
    """Bytes of ``lay``'s longest track, match or trap: each runs from a seed
    bit up to the next end bit of its word (tracks never span words)."""
    n = 0
    for wl in lay.all_words():
        ends = wl.endmask | wl.trap_endmask
        for e in range(32):
            if ends >> e & 1:
                start = (wl.seed & ((2 << e) - 1)).bit_length() - 1
                n = max(n, e - start + 1)
    return n


def make_host_exact(machine: AcMachine):
    """Host composed-DFA engine for localized trap recovery (C++ when the
    toolchain exists, else None — callers fall back to the scalar scan)."""
    try:
        return CppAcEngine(machine)
    except NativeUnavailable:
        return None


def host_stream_count(machine, host_eng, data, emit_len, n, warm_s, s) -> int:
    """Exact match count owned by stream ``s`` (ends in its emission
    region), re-derived from the raw corpus bytes: count(window) minus
    count(warm prefix) — every match ending in the warm replay lies
    entirely inside it, so the difference is exactly the matches ending in
    [start, end).  Shared by the single-chip and mesh localized trap
    recovery paths."""
    L = emit_len
    start = s * L
    end = min(start + L, n)
    warm = int(warm_s)
    lo = start - warm
    if host_eng is not None:
        total = host_eng.count(data[lo:end])
        head = host_eng.count(data[lo:start]) if warm else 0
    else:
        total = ac.count_matches(machine, data[lo:end])
        head = ac.count_matches(machine, data[lo:start]) if warm else 0
    return total - head


@dataclass
class BitapTables:
    """The B2, B4 and B7 kernels' tables on one device
    (``convert.bitap_tables_from_jax`` builds the same from the JAX engine's
    arrays), over the layout's ``all_words()``: the match words, then the
    standalone trap register if there is one (``endmask`` 0, no fields: it
    never counts)."""

    btab: torch.Tensor  # int32 [VT, 256] byte -> track mask per word
    seed: torch.Tensor  # int32 [VT]
    endmask: torch.Tensor  # int32 [VT]
    field_start: torch.Tensor  # int32 [VT + 1]: word w owns fields [start[w], start[w+1])
    field_bit: torch.Tensor  # int32 [F] end bit of each field
    field_weight: torch.Tensor  # int32 [F] multiplicity of each field
    #: int32 [VT]: each match word's ``trap_endmask`` and the trap
    #: register's ``endmask``; None for a layout without trap tracks.
    trapmask: Optional[torch.Tensor] = None
    #: Bytes of the layout's longest track, match or trap (``longest_track``).
    max_track_bytes: int = 0

    def check_overlap(self, overlap: int) -> None:
        """Raise ``ValueError`` when ``overlap``, the warm-up over which B2's
        and B4's segments restart their registers, is shorter than the
        longest track less one: the segments would miss matches and traps."""
        if overlap < self.max_track_bytes - 1:
            raise ValueError(f"the staging's overlap {overlap} is below this layout's "
                             f"longest track less one ({self.max_track_bytes - 1})")

    @staticmethod
    def from_layout(lay: BitapLayout, device, btab: Optional[np.ndarray] = None) -> "BitapTables":
        """Tables for ``lay``; ``btab`` ([VT, 256]) overrides the masks taken
        from the layout."""
        words = lay.all_words()
        if btab is None:
            btab = np.stack([wl.btab for wl in words])
        starts = np.cumsum([0] + [len(wl.fields) for wl in words])
        fields = [f for wl in words for f in wl.fields]
        reg = [lay.trap] if lay.trap is not None else []

        def i32(x):
            return torch.from_numpy(np.array(x, dtype=np.int32)).to(device)

        return BitapTables(
            btab=i32(btab),
            seed=i32([wl.seed for wl in words]),
            endmask=i32([wl.endmask for wl in lay.words] + [0] * len(reg)),
            field_start=i32(starts),
            field_bit=i32([e for e, _, _ in fields]),
            field_weight=i32([w for _, _, w in fields]),
            trapmask=(i32([wl.trap_endmask for wl in lay.words] + [wl.endmask for wl in reg])
                      if lay.has_trap else None),
            max_track_bytes=longest_track(lay),
        )


class BitapAcEngine(DenseAcEngine):
    """``DenseAcEngine`` whose counts, containsAny and per-needle presence go
    through the bitap kernels B2, B4 and B7.

    Staging, stream plans, ``adopt_staged`` and extraction are the dense
    engine's; the dense tables of a bitap-eligible machine are tiny, so the
    engine keeps both.  For a composed IgnoreCase machine the dense tables
    are the composed machine's, which the trap recovery re-scans with."""

    #: Trapped-stream budget for localized recovery: above this fraction of
    #: live streams, one full dense re-scan beats per-stream host loops.
    TRAP_LOCAL_FRAC = 0.01

    def __init__(self, machine: AcMachine, layout: Optional[BitapLayout] = None, **kw):
        super().__init__(machine, **kw)
        lay = layout if layout is not None else plan_bitap(machine)
        if lay is None:
            raise ValueError("machine is not bitap-eligible; use plan_bitap first")
        self.bitap = lay
        self.bitap_tables = BitapTables.from_layout(lay, self.device)
        self._host_exact_eng = None

    def _kernel_args(self, st: StagedStreams) -> tuple:
        """Arguments of ``bitap_count`` (or its plain version): the trap mask
        (None without trap tracks), then the plan's warm-up, over which the
        kernel's segments restart their registers (``BitapTables.check_overlap``
        raises when it is too short)."""
        t = self.bitap_tables
        t.check_overlap(st.plan.overlap)
        return (st.streams, t.btab, t.seed, t.endmask, t.field_start, t.field_bit,
                t.field_weight, st.warm, t.trapmask, st.plan.overlap)

    def stream_counts(self, st: StagedStreams):
        """int32 [S] per-stream counts on the device (kernel B2); for a trap
        layout ``(counts, trap)``, trap the per-stream OR of the trap bits."""
        return bitap_count(*self._kernel_args(st))

    def stream_counts_plain(self, st: StagedStreams):
        return bitap_count_plain(*self._kernel_args(st))

    def sticky_bitap_args(self, st: StagedStreams) -> tuple:
        """The streams and tables of ``bitap_contains`` and ``bitap_presence``
        (or their plain versions), with the trap mask for a trap layout, and
        no overlap: either kernel then scans each stream whole, as one
        segment.  The engine's own calls take :meth:`contains_args` and
        :meth:`presence_args`."""
        t = self.bitap_tables
        args = (st.streams, t.btab, t.seed, t.endmask)
        return args if t.trapmask is None else (*args, t.trapmask)

    def contains_args(self, st: StagedStreams) -> tuple:
        """Arguments of ``bitap_contains`` (or its plain version): the trap
        mask (None without trap tracks), then the plan's warm-up, over which
        the kernel's segments restart their registers
        (``BitapTables.check_overlap`` raises when it is too short)."""
        t = self.bitap_tables
        t.check_overlap(st.plan.overlap)
        return (st.streams, t.btab, t.seed, t.endmask, t.trapmask, st.plan.overlap)

    def presence_args(self, st: StagedStreams) -> tuple:
        """Arguments of ``bitap_presence`` (or its plain version), as
        :meth:`contains_args`: the trap mask (None without trap tracks), then
        the plan's warm-up, checked before any launch."""
        return self.contains_args(st)

    # -- trap recovery (JAX ``bitap_scan.py:717-782``) -------------------------

    def _trapped_streams(self, trap: np.ndarray, st: StagedStreams) -> Optional[np.ndarray]:
        """Live stream indices whose trap fired, or None when the full dense
        re-scan is the cheaper recovery (too many trapped streams, or no host
        copy of the corpus to re-count from)."""
        idx = np.flatnonzero((trap.reshape(-1) != 0) & st.live_np.reshape(-1))
        if len(idx) == 0:
            return idx
        if st.data_np is None:
            return None
        if len(idx) > max(32, int(int(st.live_np.sum()) * self.TRAP_LOCAL_FRAC)):
            return None
        return idx

    def _host_count_stream(self, st: StagedStreams, s: int) -> int:
        with trace.span("amt.host_recount"):
            if self._host_exact_eng is None:
                self._host_exact_eng = make_host_exact(self.machine)
            return host_stream_count(
                self.machine, self._host_exact_eng, st.data_np, st.plan.emit_len, st.plan.n,
                st.warm_np[s], s,
            )

    def _dense_count_staged(self, st: StagedStreams) -> int:
        """The count by the dense kernel B1 on the (composed) machine."""
        with trace.span("amt.host_recount"):
            return sum_live(dense_count(*DenseAcEngine._kernel_args(self, st)), st.live_np)

    def count_staged(self, st: StagedStreams) -> int:
        """Total count over live streams (B2).  Where a trap fired, the
        trapped streams are re-counted on the host, or the whole staging is
        re-counted by B1."""
        if self.bitap_tables.trapmask is None:
            return super().count_staged(st)
        out = self.stream_counts(st)
        with trace.span("amt.readback"):
            counts, trap = (o.cpu().numpy() for o in out)
        trapped = self._trapped_streams(trap, st)
        if trapped is None:
            return self._dense_count_staged(st)
        counts = counts.astype(np.int64)
        for s in trapped:
            counts[s] = self._host_count_stream(st, int(s))
        with trace.span("amt.reduce"):
            return int(counts[st.live_np].sum())

    def contains_staged(self, st: StagedStreams) -> bool:
        """True iff a needle ends in some live stream: one sticky scan (B4).
        A track hit is a match even under traps; without one, a trapped
        stream is decided on the host, or the dense sticky scan (B3)
        decides."""
        out = bitap_contains(*self.contains_args(st))
        if self.bitap_tables.trapmask is None:
            return bool((out.cpu().numpy()[st.live_np] != 0).any())
        hits, trap = (o.cpu().numpy() for o in out)
        if (hits[st.live_np] != 0).any():
            return True
        trapped = self._trapped_streams(trap, st)
        if trapped is None:
            return self._any_absorbed(dense_contains(*self.sticky_args(st)), st.live_np)
        return any(self._host_count_stream(st, int(s)) > 0 for s in trapped)

    def contains_staged_early(self, st: StagedStreams, n_segments=None) -> bool:
        """Bitap keeps the one-shot scan, as in the JAX package."""
        return self.contains_staged(st)

    def _needle_key(self, nd) -> Optional[bytes]:
        """The track key a needle's flag lives under (CS: its bytes; CI:
        its lowered re-encoding)."""
        return ci_track_key(nd) if self.bitap.ci else bytes(nd)

    def needle_presence_staged(self, st: StagedStreams) -> Optional[np.ndarray]:
        """bool per entry of ``machine.needles`` (duplicates share a flag):
        whether the needle occurs.  One sticky scan (B7) gives a plane per
        word; the host ORs each over the live streams and reads every track's
        end bit as its needle's flag.  None when a trap fired: the flags could
        under-report, and the caller takes the extraction route."""
        lay = self.bitap
        planes = bitap_presence(*self.presence_args(st)).cpu().numpy()
        aggs = [
            int(np.bitwise_or.reduce(p[st.live_np].astype(np.int64), initial=0)) for p in planes
        ]
        if lay.trap is not None and aggs[lay.n_words] != 0:
            return None
        if any(aggs[w] & int(wl.trap_endmask) for w, wl in enumerate(lay.words)):
            return None
        flag = {}
        for w, wl in enumerate(lay.words):
            for key, (eb, _, _) in zip(wl.keys, wl.fields):
                flag[key] = bool(aggs[w] & (1 << eb))
        return np.asarray([flag[self._needle_key(nd)] for nd in self.machine.needles], dtype=bool)

    def value_presence_staged(self, st: StagedStreams, n_values: int) -> np.ndarray:
        """bool [n_values]: one sticky scan (B7), whose track end bits flag
        the needles (value ids are needle entries); where a trap fired, the
        flags could under-report, and the extraction route decides."""
        pres = self.needle_presence_staged(st)
        return pres if pres is not None else super().value_presence_staged(st, n_values)

    def bits_args(self, st: StagedStreams) -> tuple:
        """Arguments of ``matchbits``: the bitap step for a one-word layout
        without trap tracks; else the dense step, as in the JAX package."""
        if self.bitap.n_words != 1 or self.bitap.has_trap:
            return super().bits_args(st)
        t = self.bitap_tables
        return (
            st.streams, st.warm, st.vend, "bitap",
            t.btab, t.seed, t.endmask, t.field_start, t.field_bit, t.field_weight,
        )


__all__ = [
    "MAX_TRACK_BITS",
    "BitapAcEngine",
    "BitapLayout",
    "BitapTables",
    "WordLayout",
    "ci_track_key",
    "host_stream_count",
    "make_host_exact",
    "plan_bitap",
    "plan_bitap_ci",
]
