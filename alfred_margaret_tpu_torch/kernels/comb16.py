"""B8 ``comb16_count``, B10 ``comb16_contains`` and B12 ``comb16_states``: the
three-tier 16-bit comb DFA scans.

Wrappers of the kernels that replace the Pallas kernels
``alfred_margaret_tpu/ops/comb16_scan.py:_make_c16_count_kernel`` (B8),
``_make_c16_contains_kernel`` (B10) and ``_make_c16_states_kernel`` (B12),
one-group modes of ``csrc/comb16_grouped.cu``'s segmented scan.  A CUDA
tensor launches the kernel; a CPU tensor runs the plain torch version.
Nothing falls back from one to the other.  With the stream plan's
``overlap`` B8 cuts each stream into segments, as B9 does
(``kernels/segments.py:run_segments``), B10 combines its segments' final
bases as B11's one-group mode does (``kernels/segments.py:
entry_over_segments``), and B12 writes each segment's rows of its own range,
as B17 does (``kernels/segments.py:stitch_segments``).

The tables are ``Comb16Tables.args()``: ``classmap`` [256], ``comb``
[rows_c * 128] and ``aux`` [rows_a * 128] (pairs of 16-bit entries, low half
first), ``root_row`` and ``segtable`` [128], ``ranges`` [6] (count ranges
padded with ``2**BB``), then the ints ``BB``, ``owner_mask``, ``CB`` and
``root_cb``, the base every scan starts from.  One step from base ``cb`` on
byte class ``cls``:

    e1 = comb entry cb + cls        hit1: its owner field == cb & owner_mask
    cbv = segtable[cb >> (BB - 7)]
    e2 = aux entry cbv + cls        hit2: its owner field == cbv & owner_mask
    e = e1 if hit1 else e2 if hit2 else root_row[cls];   next base = e & (2**BB - 1)

and the step's count is ``(e >> 15) & 1`` plus the ranges the next base
reaches (zero when ``CB == 0``).
"""

from __future__ import annotations

import torch

from .common import check_overlap, check_streams, check_tables, launch, on_cpu
from .segments import Design, grouped_design, sm_count

#: Count ranges the kernels read (MAX_COUNT16 - 1; kC16Ranges in
#: csrc/comb16.cuh).
N_RANGES = 6
#: comb plus aux words the kernels hold in shared memory (kC16MaxTableWords
#: in csrc/comb16.cuh): MAX_ROWS rows of 128 entries.
MAX_TABLE_WORDS = 48 * 128


def check_split(BB, owner_mask, CB) -> None:
    """Raise ``ValueError`` unless ``(CB, OB, BB)`` is a comb16 field split
    the kernels take: 16 bits in all, a 4- or 5-bit owner mask."""
    OB = int(owner_mask).bit_length()
    if owner_mask != (1 << OB) - 1 or CB not in (0, 1) or not 8 <= BB <= 15 or BB + OB + CB != 16:
        raise ValueError(f"bad comb16 field split: BB={BB} owner_mask={owner_mask} CB={CB}")


def check_comb16(streams, classmap, comb, aux, root_row, segtable, ranges, BB, owner_mask, CB,
                 root_cb, **vectors):
    """The checks of the comb16 kernels (B8, B10, B13): streams, tables
    (``ranges`` None for B10, which counts nothing), field split, and
    ``[S]`` vectors such as ``warm``."""
    _, S = check_streams(streams)
    if comb.dim() != 1 or aux.dim() != 1 or comb.numel() < 1 or aux.numel() < 1:
        raise ValueError("comb and aux must be non-empty 1-D tables")
    if comb.numel() + aux.numel() > MAX_TABLE_WORDS:
        raise ValueError(f"comb and aux hold {comb.numel() + aux.numel()} words; "
                         f"the kernels hold at most {MAX_TABLE_WORDS}")
    check_split(BB, owner_mask, CB)
    if not 0 <= root_cb < (1 << BB):
        raise ValueError(f"root base {root_cb} outside the {BB}-bit base space")
    tables = {
        "classmap": (classmap, (256,)), "comb": (comb, (comb.numel(),)),
        "aux": (aux, (aux.numel(),)), "root_row": (root_row, (128,)),
        "segtable": (segtable, (128,)), **{name: (x, (S,)) for name, x in vectors.items()},
    }
    if ranges is not None:
        tables["ranges"] = (ranges, (N_RANGES,))
    check_tables(streams.device, tables)


class Plain16:
    """The tables as int64 tensors, and one step of the lookup over a
    vector of streams: the plain version shared by B8, B10 and B13."""

    def __init__(self, classmap, comb, aux, root_row, segtable, ranges, BB, owner_mask, CB):
        self.cm = classmap.long()
        self.comb = comb.long() & 0xFFFFFFFF  # entries are unsigned
        self.aux = aux.long() & 0xFFFFFFFF
        self.root = root_row.long()
        self.seg = segtable.long()
        self.ranges = None if ranges is None else ranges.long().unsqueeze(1)
        self.BB, self.om, self.CB = BB, owner_mask, CB

    def entry(self, cb, b):
        """The 16-bit entry for bases ``cb`` on bytes ``b`` (int64 [S])."""
        cls = self.cm[b]
        w1 = cb + cls
        e1 = (self.comb[w1 >> 1] >> ((w1 & 1) << 4)) & 0xFFFF
        cbv = self.seg[cb >> (self.BB - 7)]
        w2 = cbv + cls
        e2 = (self.aux[w2 >> 1] >> ((w2 & 1) << 4)) & 0xFFFF
        hit1 = ((e1 >> self.BB) & self.om) == (cb & self.om)
        hit2 = ((e2 >> self.BB) & self.om) == (cbv & self.om)
        return torch.where(hit1, e1, torch.where(hit2, e2, self.root[cls]))

    def step(self, cb, b):
        """(next bases, counts) for bases ``cb`` on bytes ``b``."""
        e = self.entry(cb, b)
        nb = e & ((1 << self.BB) - 1)
        if not self.CB:
            return nb, torch.zeros_like(nb)
        return nb, ((e >> 15) & 1) + (nb.unsqueeze(0) >= self.ranges).sum(0)


def comb16_count_plain(streams, warm, vend, classmap, comb, aux, root_row, segtable, ranges,
                       BB, owner_mask, CB, root_cb, overlap=None):
    """Plain torch version of B8: one lookup per time step, counts added
    where ``warm <= t < vend``.  (``overlap`` only lets the kernel cut the
    streams into segments.)"""
    T, S = streams.shape
    p = Plain16(classmap, comb, aux, root_row, segtable, ranges, BB, owner_mask, CB)
    warm, vend = warm.long(), vend.long()
    cb = torch.full((S,), root_cb, dtype=torch.int64, device=streams.device)
    counts = torch.zeros(S, dtype=torch.int64, device=streams.device)
    for t in range(T):
        cb, cnt = p.step(cb, streams[t].long())
        counts += torch.where((warm <= t) & (t < vend), cnt, 0)
    return counts.to(torch.int32)


def comb16_count_design(streams, comb, aux, overlap=None) -> Design:
    """The segments ``comb16_count`` (B8), ``comb16_contains`` (B10) and
    ``comb16_states`` (B12) cut these CUDA streams into for tables of
    ``comb`` and ``aux`` words (B9's rule for one group, with the block's
    shared memory for those tables)."""
    T, S = streams.shape
    return grouped_design(S, T, overlap, 1, comb.numel(), aux.numel(), sm_count(streams.device))


def comb16_count(streams, warm, vend, classmap, comb, aux, root_row, segtable, ranges,
                 BB, owner_mask, CB, root_cb, overlap=None):
    """int32 [S] counts of the matches ending at t in [warm[s], vend[s]) of
    each stream of ``streams`` ([T, S] uint8), scanned from ``root_cb``.
    With the stream plan's ``overlap`` the kernel may cut each stream into
    segments; without, it scans each whole."""
    check_comb16(streams, classmap, comb, aux, root_row, segtable, ranges, BB, owner_mask, CB,
                 root_cb, warm=warm, vend=vend)
    check_overlap(overlap)
    if on_cpu(streams):
        return comb16_count_plain(streams, warm, vend, classmap, comb, aux, root_row, segtable,
                                  ranges, BB, owner_mask, CB, root_cb)
    T, S = streams.shape
    d = comb16_count_design(streams, comb, aux, overlap)
    out = torch.zeros(S, dtype=torch.int32, device=streams.device)
    launch(
        "amt_comb16_count", streams.device,
        streams.data_ptr(), T, S, warm.data_ptr(), vend.data_ptr(),
        classmap.data_ptr(), comb.data_ptr(), comb.numel(), aux.data_ptr(), aux.numel(),
        root_row.data_ptr(), segtable.data_ptr(), ranges.data_ptr(),
        BB, owner_mask, CB, root_cb, overlap or 0, d.segments, out.data_ptr(),
    )
    comb16_count.launches += 1
    return out


def comb16_contains_plain(streams, vend, classmap, comb, aux, root_row, segtable, BB,
                          owner_mask, root_cb, absorb, overlap=None):
    """Plain torch version of B10: one lookup per time step, the base held
    where ``t >= vend``.  (``absorb`` only lets the kernel stop early, and
    ``overlap`` cut the streams into segments.)"""
    T, S = streams.shape
    p = Plain16(classmap, comb, aux, root_row, segtable, None, BB, owner_mask, 0)
    vend = vend.long()
    cb = torch.full((S,), root_cb, dtype=torch.int64, device=streams.device)
    for t in range(T):
        nb, _ = p.step(cb, streams[t].long())
        cb = torch.where(t < vend, nb, cb)
    return cb.to(torch.int32)


def comb16_contains(streams, vend, classmap, comb, aux, root_row, segtable, BB, owner_mask,
                    root_cb, absorb, overlap=None):
    """int32 [S]: the final base of each stream of ``streams`` ([T, S]
    uint8) on the sticky view's tables, scanned from ``root_cb`` over
    ``t < vend[s]``.  A stream saw a match iff its base is ``absorb``.  With
    the stream plan's ``overlap`` the kernel may cut each stream into
    segments; without, it scans each whole."""
    check_comb16(streams, classmap, comb, aux, root_row, segtable, None, BB, owner_mask, 0,
                 root_cb, vend=vend)
    if not 0 <= absorb < (1 << BB):
        raise ValueError(f"absorbing base {absorb} outside the {BB}-bit base space")
    check_overlap(overlap)
    if on_cpu(streams):
        return comb16_contains_plain(streams, vend, classmap, comb, aux, root_row, segtable, BB,
                                     owner_mask, root_cb, absorb)
    T, S = streams.shape
    d = comb16_count_design(streams, comb, aux, overlap)
    out = torch.empty(S, dtype=torch.int32, device=streams.device)  # the root base, in the launch
    launch(
        "amt_comb16_contains", streams.device,
        streams.data_ptr(), T, S, vend.data_ptr(),
        classmap.data_ptr(), comb.data_ptr(), comb.numel(), aux.data_ptr(), aux.numel(),
        root_row.data_ptr(), segtable.data_ptr(), BB, owner_mask, root_cb, absorb, overlap or 0,
        d.segments, out.data_ptr(),
    )
    comb16_contains.launches += 1
    return out


def comb16_states_plain(streams, classmap, comb, aux, root_row, segtable, BB, owner_mask, CB,
                        root_cb, overlap=None):
    """Plain torch version of B12: the 16-bit entry of every step.
    (``overlap`` only lets the kernel cut the streams into segments.)"""
    T, S = streams.shape
    p = Plain16(classmap, comb, aux, root_row, segtable, None, BB, owner_mask, CB)
    cb = torch.full((S,), root_cb, dtype=torch.int64, device=streams.device)
    out = torch.empty(T, S, dtype=torch.int64, device=streams.device)
    for t in range(T):
        out[t] = p.entry(cb, streams[t].long()) & 0xFFFF
        cb = out[t] & ((1 << BB) - 1)
    return out.to(torch.int32)


def comb16_states(streams, classmap, comb, aux, root_row, segtable, BB, owner_mask, CB, root_cb,
                  overlap=None):
    """int32 [T, S]: the 16-bit entry (count bit at 15 when ``CB``, base in
    the low ``BB`` bits) of the state each stream of ``streams`` ([T, S]
    uint8) enters at every step t, scanned from ``root_cb`` with no emission
    window.  ``CB`` is only checked with the field split.  With the stream
    plan's ``overlap`` the kernel may cut each stream into segments; without,
    it scans each whole."""
    check_comb16(streams, classmap, comb, aux, root_row, segtable, None, BB, owner_mask, CB,
                 root_cb)
    check_overlap(overlap)
    if on_cpu(streams):
        return comb16_states_plain(streams, classmap, comb, aux, root_row, segtable, BB,
                                   owner_mask, CB, root_cb)
    T, S = streams.shape
    d = comb16_count_design(streams, comb, aux, overlap)
    out = torch.empty(T, S, dtype=torch.int32, device=streams.device)
    launch(
        "amt_comb16_states", streams.device,
        streams.data_ptr(), T, S,
        classmap.data_ptr(), comb.data_ptr(), comb.numel(), aux.data_ptr(), aux.numel(),
        root_row.data_ptr(), segtable.data_ptr(), BB, owner_mask, CB, root_cb, overlap or 0,
        d.segments, out.data_ptr(),
    )
    comb16_states.launches += 1
    return out


#: Kernel launches since the last reset (CPU calls do not count).
comb16_count.launches = 0
comb16_contains.launches = 0
comb16_states.launches = 0

__all__ = [
    "Plain16",
    "check_comb16",
    "check_split",
    "comb16_contains",
    "comb16_contains_plain",
    "comb16_count",
    "comb16_count_design",
    "comb16_count_plain",
    "comb16_states",
    "comb16_states_plain",
]
