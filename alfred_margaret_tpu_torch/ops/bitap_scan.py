"""Bitap (shift-AND) engine over the hand-written CUDA kernels B2, B4, B6
and B7.

Counterpart of ``alfred_margaret_tpu/ops/bitap_scan.py``: ``WordLayout``,
``BitapLayout``, ``_pack_words``, ``_plan_tracks`` and ``plan_bitap`` are
copied as numpy (that module imports ``jax``; ``tests/test_torch_layout.py``
pins the copies to the originals), and ``BitapAcEngine`` takes the place of
the JAX ``BitapAcEngine`` for counting (B2), containsAny (B4), per-needle
presence for containsAll (B7) and, through the dense engine's extraction
path, the one-word bitap step of the hit bitmap (B6).  The IgnoreCase
planner (``plan_bitap_ci``) and trap layouts come with the IgnoreCase slice;
this engine raises ``NotImplementedError`` on a layout with trap tracks.

Every unique needle is one bit track in an int32 register; a stream steps
``D = ((D << 1) | SEED) & B[byte]`` and each track's end bit counts its
needle, weighted by how often the needle occurs in the needle list.  So
overlapping matches, suffix needles and duplicate needles count exactly as
the Aho-Corasick machine counts them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels.bitap_contains import bitap_contains, bitap_presence
from ..kernels.bitap_count import bitap_count, bitap_count_plain
from ..models.ac import AcMachine
from .pallas_scan import DenseAcEngine, StagedStreams

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
    #: per track: the needle bytes, aligned with ``fields``
    keys: Tuple[bytes, ...] = ()
    #: end bits of IgnoreCase trap tracks riding this word (0 for
    #: CaseSensitive layouts, the only ones this package plans).
    trap_endmask: int = 0


@dataclass(frozen=True)
class BitapLayout:
    """Multi-word track layout: needles bin-packed into ``V`` int32
    registers per stream."""

    words: Tuple[WordLayout, ...]
    unroll: int  # flush block size of the TPU kernel (2**min_headroom > unroll)
    #: IgnoreCase trap register (None for CaseSensitive layouts).
    trap: Optional[WordLayout] = None
    #: True for byte-class (composed IgnoreCase) layouts.
    ci: bool = False

    @property
    def n_words(self) -> int:
        return len(self.words)

    @property
    def has_trap(self) -> bool:
        """True when any trap tracks exist (IgnoreCase layouts)."""
        return self.trap is not None or any(w.trap_endmask for w in self.words)


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


@dataclass
class BitapTables:
    """The B2 kernel's tables on one device (``convert.bitap_tables_from_jax``
    builds the same from the JAX engine's arrays)."""

    btab: torch.Tensor  # int32 [V, 256] byte -> track mask per word
    seed: torch.Tensor  # int32 [V]
    endmask: torch.Tensor  # int32 [V]
    field_start: torch.Tensor  # int32 [V + 1]: word w owns fields [start[w], start[w+1])
    field_bit: torch.Tensor  # int32 [F] end bit of each field
    field_weight: torch.Tensor  # int32 [F] multiplicity of each field

    @staticmethod
    def from_layout(lay: BitapLayout, device, btab: Optional[np.ndarray] = None) -> "BitapTables":
        """Tables for ``lay``'s match words; ``btab`` ([V, 256]) overrides
        the masks taken from the layout."""
        if lay.has_trap:
            raise NotImplementedError(
                "bitap trap layouts (IgnoreCase) are ROADMAP Queue A item 11"
            )
        if btab is None:
            btab = np.stack([wl.btab for wl in lay.words])
        starts = np.cumsum([0] + [len(wl.fields) for wl in lay.words])
        fields = [f for wl in lay.words for f in wl.fields]

        def i32(x):
            return torch.from_numpy(np.array(x, dtype=np.int32)).to(device)

        return BitapTables(
            btab=i32(btab),
            seed=i32([wl.seed for wl in lay.words]),
            endmask=i32([wl.endmask for wl in lay.words]),
            field_start=i32(starts),
            field_bit=i32([e for e, _, _ in fields]),
            field_weight=i32([w for _, _, w in fields]),
        )


class BitapAcEngine(DenseAcEngine):
    """``DenseAcEngine`` whose counts go through the bitap kernel B2.

    Staging, stream plans and ``adopt_staged`` are the dense engine's; the
    dense tables of a bitap-eligible machine are tiny, so the engine keeps
    both."""

    def __init__(self, machine: AcMachine, layout: Optional[BitapLayout] = None, **kw):
        super().__init__(machine, **kw)
        lay = layout if layout is not None else plan_bitap(machine)
        if lay is None:
            raise ValueError("machine is not bitap-eligible; use plan_bitap first")
        self.bitap = lay
        self.bitap_tables = BitapTables.from_layout(lay, self.device)

    def _kernel_args(self, st: StagedStreams) -> tuple:
        t = self.bitap_tables
        return (
            st.streams, t.btab, t.seed, t.endmask,
            t.field_start, t.field_bit, t.field_weight, st.warm,
        )

    def stream_counts(self, st: StagedStreams) -> torch.Tensor:
        """int32 [S] per-stream counts on the device (kernel B2)."""
        return bitap_count(*self._kernel_args(st))

    def stream_counts_plain(self, st: StagedStreams) -> torch.Tensor:
        return bitap_count_plain(*self._kernel_args(st))

    def sticky_bitap_args(self, st: StagedStreams) -> tuple:
        """Arguments of ``bitap_contains`` and ``bitap_presence`` (or their
        plain versions)."""
        t = self.bitap_tables
        return (st.streams, t.btab, t.seed, t.endmask)

    def contains_staged(self, st: StagedStreams) -> bool:
        """True iff a needle ends in some live stream: one sticky scan (B4)."""
        hits = bitap_contains(*self.sticky_bitap_args(st)).cpu().numpy()
        return bool((hits[st.live_np] != 0).any())

    def contains_staged_early(self, st: StagedStreams, n_segments=None) -> bool:
        """Bitap keeps the one-shot scan, as in the JAX package."""
        return self.contains_staged(st)

    def needle_presence_staged(self, st: StagedStreams) -> np.ndarray:
        """bool per entry of ``machine.needles`` (duplicates share a flag):
        whether the needle occurs.  One sticky scan (B7) gives a plane per
        word; the host ORs each over the live streams and reads every track's
        end bit as its needle's flag."""
        planes = bitap_presence(*self.sticky_bitap_args(st)).cpu().numpy()
        aggs = [
            int(np.bitwise_or.reduce(p[st.live_np].astype(np.int64), initial=0)) for p in planes
        ]
        flag = {}
        for w, wl in enumerate(self.bitap.words):
            for key, (eb, _, _) in zip(wl.keys, wl.fields):
                flag[key] = bool(aggs[w] & (1 << eb))
        return np.asarray([flag[bytes(nd)] for nd in self.machine.needles], dtype=bool)

    def bits_args(self, st: StagedStreams) -> tuple:
        """Arguments of ``matchbits``: the bitap step for a one-word layout;
        with more words the dense step, as in the JAX package."""
        if self.bitap.n_words != 1:
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
    "plan_bitap",
]
