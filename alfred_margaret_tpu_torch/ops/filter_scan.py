"""Stride-2 candidate screen: the hit-sparse ``containsAny`` fast path of
the comb16 engine, over the hand-written CUDA kernel B14.

Counterpart of ``alfred_margaret_tpu/ops/filter_scan.py``: ``FilterWord``,
``FilterLayout``, ``_chains``, ``_entries``, ``plan_filter`` and ``_pack``
are copied as numpy (``tests/test_torch_filter.py`` pins the layouts to the
originals'), and ``attach_filter`` and ``filter_contains`` drive the port's
kernel with the same strike and reset rule.

The screen runs a shift-AND register automaton over byte PAIRS, one step per
two bytes, its tables indexed by the 7-bit hash ``((b1 & 15) << 3) | (b2 &
7)``.  Needles of 3 bytes or fewer run exactly as rolling-window compares
(their plane answers True outright); needles of 4 bytes or more become union
buckets of alignment chains whose end-bit fires are candidates only (hash
collisions and union mixing give false positives), so a candidate-only
verdict falls through to the exact sticky scan.  A corpus with no fire is
answered False without it.  The candidate plane is a superset of the long
needles' true match ends: every alignment is tracked, and the registers
freeze at each stream's valid end, so right padding can neither fire nor
erase a pending fire.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..kernels.filter_contains import filter_contains as filter_kernel

#: Union-bucket size: half-pair boundary constraints carry 16 entries per
#: needle over the 128-entry tables, so k needles/bucket put the chain
#: boundaries at density k/8..k/16; k ~ 5 keeps screening useful while a
#: word still covers ~5-6 buckets.  The planner constants are the JAX
#: package's, so both packages plan the same screen.
BUCKET_K = 5

#: Rolling-window compare budget: each short needle costs two compares per
#: pair step.
MAX_SHORTS = 8

#: Usable track bits per word (bit 31 = int32 sign stays clear).
WORD_BITS = 31


@dataclass(frozen=True)
class FilterWord:
    seed: int
    endmask: int
    btab: np.ndarray  # int64 [128] pair-hash -> track mask


@dataclass(frozen=True)
class FilterLayout:
    """Sticky filter plan: V candidate pair-words + K exact short compares."""

    words: Tuple[FilterWord, ...]
    #: (mask, const) int32 pairs for the rolling-window compares, one per
    #: short needle (<= 4 bytes, big-endian packed).
    shorts: Tuple[Tuple[int, int], ...]

    @property
    def n_words(self) -> int:
        return len(self.words)


def _i32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v


def _chains(nd: bytes) -> List[List[Tuple[Optional[int], Optional[int]]]]:
    """Even/odd alignment chains as (b1, b2) pair constraints; None =
    wildcard half (chain boundaries where the needle covers only one byte
    of the pair)."""
    L = len(nd)
    ev = []
    i = 0
    while i < L:
        ev.append((nd[i], nd[i + 1] if i + 1 < L else None))
        i += 2
    od: List[Tuple[Optional[int], Optional[int]]] = [(None, nd[0])]
    i = 1
    while i < L:
        od.append((nd[i], nd[i + 1] if i + 1 < L else None))
        i += 2
    return [ev, od]


def _entries(con) -> List[int]:
    b1, b2 = con
    his = range(16) if b1 is None else [b1 & 15]
    los = range(8) if b2 is None else [b2 & 7]
    return [(h << 3) | l for h in his for l in los]


def plan_filter(machine, max_words: int = 3) -> Optional[FilterLayout]:
    """Sticky-filter layout for ``machine``'s needles, or None.

    Eligible: CaseSensitive byte semantics (composed-CI machines would
    need byte-class chains — not built), no empty needle, no NUL byte,
    at most :data:`MAX_SHORTS` needles under 4 bytes, and the chain
    buckets (needles >= 4 bytes) fitting ``max_words`` words.  Machines
    whose exact bitap plan exists never get here (the dispatcher prefers
    exact kernels)."""
    if getattr(machine, "composed_ci", False):
        return None
    needles = [bytes(nd) for nd in getattr(machine, "needles", [])]
    if not needles:
        return None
    shorts: List[Tuple[int, int]] = []
    longs: List[bytes] = []
    for nd in set(needles):
        if len(nd) == 0 or 0 in nd:
            return None
        if len(nd) <= 3:
            # <= 3 bytes: a pair chain would carry a half-pair at BOTH
            # boundaries (density k/8 * k/16 — all fire, no screen), so
            # these run as exact rolling compares instead.
            const = 0
            for x in nd:
                const = (const << 8) | x
            shorts.append((_i32((1 << (8 * len(nd))) - 1), _i32(const)))
        else:
            longs.append(nd)
    if len(shorts) > MAX_SHORTS:
        return None
    longs.sort(key=lambda n: (len(n), n))
    # Bucket size adapts upward for big sets (more union density, but the
    # alternative for them is G sticky passes at single-digit GB/s).
    for k in (BUCKET_K, 7, 10, 14):
        lay = _pack(longs, shorts, k, max_words)
        if lay is not None:
            return lay
    return None


def _pack(longs, shorts, bucket_k: int, max_words: int) -> Optional[FilterLayout]:
    words: List[FilterWord] = []
    seed = endmask = 0
    btab = np.zeros(128, dtype=np.int64)
    off = 0
    i = 0
    while i < len(longs):
        bucket = longs[i : i + bucket_k]
        chains = []
        for nd in bucket:
            chains += _chains(nd)
        W = max(len(c) for c in chains)
        if off + W > WORD_BITS:
            words.append(FilterWord(seed, endmask, btab))
            seed = endmask = 0
            btab = np.zeros(128, dtype=np.int64)
            off = 0
            if len(words) >= max_words:
                return None
            if W > WORD_BITS:
                return None  # absurd single needle (> ~60 bytes)
        end = off + W - 1
        for c in chains:
            start = end - len(c) + 1
            seed |= 1 << start
            for p, con in enumerate(c):
                for e in _entries(con):
                    btab[e] |= 1 << (start + p)
        endmask |= 1 << end
        off = end + 1
        i += bucket_k
    if off:
        words.append(FilterWord(seed, endmask, btab))
    if len(words) > max_words:
        return None
    if not words and not shorts:
        return None
    return FilterLayout(words=tuple(words), shorts=tuple(shorts))


@dataclass
class FilterTables:
    """The B14 kernel's tables on one device (``convert.filter_tables_from_jax``
    builds the same from the JAX engine's arrays)."""

    btab: torch.Tensor  # int32 [V, 128] pair hash -> track mask per word
    seed: torch.Tensor  # int32 [V]
    endmask: torch.Tensor  # int32 [V]
    short_mask: torch.Tensor  # int32 [K] byte mask of each short needle's window
    short_const: torch.Tensor  # int32 [K] the needle's bytes, big-endian

    def args(self) -> tuple:
        return (self.btab, self.seed, self.endmask, self.short_mask, self.short_const)

    @staticmethod
    def from_layout(lay: FilterLayout, device, btab: Optional[np.ndarray] = None) -> "FilterTables":
        """Tables for ``lay``; ``btab`` ([V, 128]) overrides the masks taken
        from the layout."""
        if btab is None:
            btab = (np.stack([w.btab for w in lay.words]) if lay.words
                    else np.zeros((0, 128), dtype=np.int64))
        if (np.asarray(btab) >> 31 != 0).any():
            raise ValueError("a filter track bit reached the int32 sign bit")

        def i32(x, shape=None):
            a = np.array(x, dtype=np.int64).astype(np.int32)
            return torch.from_numpy(a.reshape(shape) if shape else a).to(device)

        return FilterTables(
            btab=i32(btab, (-1, 128)),
            seed=i32([w.seed for w in lay.words]),
            endmask=i32([w.endmask for w in lay.words]),
            short_mask=i32([m for m, _ in lay.shorts]),
            short_const=i32([c for _, c in lay.shorts]),
        )


def attach_filter(engine, machine) -> bool:
    """Plan the screen for ``machine`` and attach it to ``engine``, whose
    ``contains_staged`` asks :func:`filter_contains` first.  Returns True when
    attached.  ``AMT_FILTER=0`` disables it, and so does a ``t_tile`` that is
    not a multiple of 16 (the JAX kernel's pair unroll; the port's kernel
    needs an even stream length)."""
    engine._filter_lay = None
    engine._filter_tables = None
    engine._filter_strikes = 0
    if os.environ.get("AMT_FILTER") == "0" or engine.t_tile % 16:
        return False
    lay = plan_filter(machine, max_words=3)
    if lay is None:
        return False
    engine._filter_lay = lay
    engine._filter_tables = FilterTables.from_layout(lay, engine.device)
    return True


#: Self-disable budget: union chains over same-alphabet text fire somewhere
#: in any large corpus, so after this many consecutive useless screens
#: (candidate fires, and the exact scan anyway) the engine stops asking the
#: screen; a definite verdict resets the count.
FILTER_STRIKES = 3


def filter_contains(engine, st) -> Optional[bool]:
    """Screen a staged corpus: True (an exact short-needle hit), False (no
    fire anywhere), or None (candidate fires, or the screen disabled itself:
    the caller runs the exact sticky scan).  Reads live streams only."""
    tabs = getattr(engine, "_filter_tables", None)
    if tabs is None or engine._filter_strikes >= FILTER_STRIKES:
        return None
    planes = filter_kernel(st.streams, st.vend, *tabs.args()).cpu().numpy()[:, st.live_np]
    if (planes[0] != 0).any():
        engine._filter_strikes = 0
        return True
    if (planes[1] != 0).any():
        engine._filter_strikes += 1
        return None
    engine._filter_strikes = 0
    return False


__all__ = [
    "FILTER_STRIKES",
    "FilterLayout",
    "FilterTables",
    "FilterWord",
    "attach_filter",
    "filter_contains",
    "plan_filter",
]
