"""B15 ``comb_count``, B16 ``comb_contains`` and B17 ``comb_states``: the
32-bit row-displacement comb DFA scans.

Wrappers of ``csrc/comb_scan.cu``, which replaces the Pallas kernels
``alfred_margaret_tpu/ops/comb_scan.py:_make_comb_count_kernel`` (B15),
``_make_comb_contains_kernel`` (B16) and ``_make_comb_states_kernel`` (B17)
by the count, sticky and states modes of one segmented scan.  A CUDA tensor
launches the kernel; a CPU tensor runs the plain torch version.  Nothing
falls back from one to the other.

The tables are ``CombTables.args()``: ``classmap`` [256], ``comb``
[rows_c * 128] (the displaced exception entries), ``def_table`` [rows_d *
128] (D default rows of k entries), then the ints ``k``, ``owner_bits``,
``root_base`` and ``root_def``, the root's base and default row, where
every scan starts.  Entries are int32 with bit 31 clear: ``count << 27 |
owner << (13 + def_bits) | def_idx << 13 | base``, ``def_bits = 14 -
owner_bits``.  One step from ``(cb, df)`` on byte class ``cls``:

    w = cb + cls;  v = comb[w]     hit: w < len(comb) and owner(v) == cb mod 2**owner_bits
    e = v if hit else def_table[df * k + cls]
    next (cb, df) = (e & 8191, (e >> 13) & (2**def_bits - 1));   count = e >> 27
"""

from __future__ import annotations

import torch

from .common import check_overlap, check_streams, check_tables, launch, on_cpu
from .segments import Design, comb_design, sm_count

#: comb plus default-row words the kernels hold in shared memory
#: (kMaxTableWords in csrc/comb_scan.cu): MAX_ROWS rows of 128 entries.
MAX_TABLE_WORDS = 48 * 128
BASE_BITS = 13
BASE_MASK = (1 << BASE_BITS) - 1
COUNT_SHIFT = 27


def check_comb(streams, classmap, comb, def_table, k, owner_bits, root_base, root_def,
               **vectors):
    """The checks of the comb kernels (B15, B16, B17): streams, tables, field
    split, root, and ``[S]`` vectors such as ``warm``."""
    _, S = check_streams(streams)
    if comb.dim() != 1 or def_table.dim() != 1 or comb.numel() < 1 or def_table.numel() < 1:
        raise ValueError("comb and def_table must be non-empty 1-D tables")
    if comb.numel() + def_table.numel() > MAX_TABLE_WORDS:
        raise ValueError(f"comb and def_table hold {comb.numel() + def_table.numel()} words; "
                         f"the kernels hold at most {MAX_TABLE_WORDS}")
    if not 1 <= k <= 256 or not 1 <= owner_bits <= 14:
        raise ValueError(f"bad comb fields: k={k} owner_bits={owner_bits}")
    if not 0 <= root_base <= BASE_MASK or not 0 <= root_def < (1 << (14 - owner_bits)):
        raise ValueError(f"root (base {root_base}, default row {root_def}) outside its fields")
    check_tables(streams.device, {
        "classmap": (classmap, (256,)), "comb": (comb, (comb.numel(),)),
        "def_table": (def_table, (def_table.numel(),)),
        **{name: (x, (S,)) for name, x in vectors.items()},
    })


class PlainComb:
    """The tables as int64 tensors, and one step of the lookup over a vector
    of streams: the plain version shared by B15, B16 and B17."""

    def __init__(self, classmap, comb, def_table, k, owner_bits, root_base, root_def):
        self.cm = classmap.long()
        self.comb = comb.long()
        self.deft = def_table.long()
        self.k = k
        self.owner_mask = (1 << owner_bits) - 1
        self.owner_shift = BASE_BITS + 14 - owner_bits
        self.def_mask = (1 << (14 - owner_bits)) - 1
        self.root = (root_base, root_def)

    def start(self, S: int, device):
        """The root's ``(cb, df)`` for ``S`` streams."""
        return (torch.full((S,), self.root[0], dtype=torch.int64, device=device),
                torch.full((S,), self.root[1], dtype=torch.int64, device=device))

    def entry(self, cb, df, b):
        """The packed entries for ``(cb, df)`` on bytes ``b`` (int64 [S])."""
        cls = self.cm[b]
        w = cb + cls
        m = self.comb.numel()
        v = self.comb[w.clamp(max=m - 1)]
        r = self.deft[(df * self.k + cls).clamp(max=self.deft.numel() - 1)]
        hit = (w < m) & (((v >> self.owner_shift) & self.owner_mask) == (cb & self.owner_mask))
        return torch.where(hit, v, r)

    def step(self, cb, df, b):
        """(next bases, next default rows, entries) for ``(cb, df)`` on ``b``."""
        e = self.entry(cb, df, b)
        return e & BASE_MASK, (e >> BASE_BITS) & self.def_mask, e


def comb_count_plain(streams, warm, vend, classmap, comb, def_table, k, owner_bits, root_base,
                     root_def, overlap=None):
    """Plain torch version of B15: one lookup per time step, counts added
    where ``warm <= t < vend``.  (``overlap`` only lets the kernel cut the
    streams into segments.)"""
    T, S = streams.shape
    p = PlainComb(classmap, comb, def_table, k, owner_bits, root_base, root_def)
    warm, vend = warm.long(), vend.long()
    cb, df = p.start(S, streams.device)
    counts = torch.zeros(S, dtype=torch.int64, device=streams.device)
    for t in range(T):
        cb, df, e = p.step(cb, df, streams[t].long())
        counts += torch.where((warm <= t) & (t < vend), e >> COUNT_SHIFT, 0)
    return counts.to(torch.int32)


def comb_count(streams, warm, vend, classmap, comb, def_table, k, owner_bits, root_base,
               root_def, overlap=None):
    """int32 [S] counts of the matches ending at t in [warm[s], vend[s]) of
    each stream of ``streams`` ([T, S] uint8), scanned from the root.  With
    the stream plan's ``overlap`` the kernel may cut each stream into
    segments (``kernels/segments.py``); without, it scans each whole."""
    check_comb(streams, classmap, comb, def_table, k, owner_bits, root_base, root_def,
               warm=warm, vend=vend)
    check_overlap(overlap)
    if on_cpu(streams):
        return comb_count_plain(streams, warm, vend, classmap, comb, def_table, k, owner_bits,
                                root_base, root_def)
    T, S = streams.shape
    d = comb_count_design(streams, comb, def_table, overlap)
    out = torch.zeros(S, dtype=torch.int32, device=streams.device)
    launch(
        "amt_comb_count", streams.device,
        streams.data_ptr(), T, S, warm.data_ptr(), vend.data_ptr(),
        classmap.data_ptr(), comb.data_ptr(), comb.numel(), def_table.data_ptr(),
        def_table.numel(), k, owner_bits, root_base, root_def, overlap or 0, d.segments,
        out.data_ptr(),
    )
    comb_count.launches += 1
    return out


def comb_count_design(streams, comb, def_table, overlap=None) -> Design:
    """The segments ``comb_count``, ``comb_contains`` and ``comb_states`` cut
    these CUDA streams into (the same shared memory, so the same rule)."""
    T, S = streams.shape
    return comb_design(S, T, overlap, comb.numel(), def_table.numel(), sm_count(streams.device))


def comb_contains_plain(streams, vend, classmap, comb, def_table, k, owner_bits, root_base,
                        root_def, absorb, overlap=None):
    """Plain torch version of B16: one lookup per time step, the state held
    where ``t >= vend``.  (``absorb`` only lets the kernel stop early, and
    ``overlap`` cut the streams into segments.)"""
    T, S = streams.shape
    p = PlainComb(classmap, comb, def_table, k, owner_bits, root_base, root_def)
    vend = vend.long()
    cb, df = p.start(S, streams.device)
    for t in range(T):
        nb, nd, _ = p.step(cb, df, streams[t].long())
        live = t < vend
        cb, df = torch.where(live, nb, cb), torch.where(live, nd, df)
    return cb.to(torch.int32)


def comb_contains(streams, vend, classmap, comb, def_table, k, owner_bits, root_base, root_def,
                  absorb, overlap=None):
    """int32 [S]: the final base of each stream of ``streams`` ([T, S]
    uint8) on the sticky view's tables, scanned from the root over ``t <
    vend[s]``.  A stream saw a match iff its base is ``absorb``.  With the
    stream plan's ``overlap`` the kernel may cut each stream into segments
    (B15's rule), whose final bases combine exactly
    (``kernels/segments.py:entry_over_segments``) while the overlap brings a
    restarted scan into the stream's state, which
    ``CombStickyTables.check_overlap`` checks for the callers; without, it
    scans each whole."""
    check_comb(streams, classmap, comb, def_table, k, owner_bits, root_base, root_def, vend=vend)
    if not 0 <= absorb <= BASE_MASK:
        raise ValueError(f"absorbing base {absorb} outside the {BASE_BITS}-bit base field")
    if absorb == root_base:  # no sticky view's root absorbs: the tables are not one
        raise ValueError(f"absorbing base {absorb} is the root's")
    check_overlap(overlap)
    if on_cpu(streams):
        return comb_contains_plain(streams, vend, classmap, comb, def_table, k, owner_bits,
                                   root_base, root_def, absorb)
    T, S = streams.shape
    d = comb_count_design(streams, comb, def_table, overlap)
    # The root base, which the owner of each stream's last step replaces.
    out = torch.full((S,), root_base, dtype=torch.int32, device=streams.device)
    launch(
        "amt_comb_contains", streams.device,
        streams.data_ptr(), T, S, vend.data_ptr(),
        classmap.data_ptr(), comb.data_ptr(), comb.numel(), def_table.data_ptr(),
        def_table.numel(), k, owner_bits, root_base, root_def, absorb, overlap or 0, d.segments,
        out.data_ptr(),
    )
    comb_contains.launches += 1
    return out


def comb_states_plain(streams, classmap, comb, def_table, k, owner_bits, root_base, root_def,
                      overlap=None):
    """Plain torch version of B17: the entry of every step.  (``overlap``
    only lets the kernel cut the streams into segments.)"""
    T, S = streams.shape
    p = PlainComb(classmap, comb, def_table, k, owner_bits, root_base, root_def)
    cb, df = p.start(S, streams.device)
    out = torch.empty(T, S, dtype=torch.int64, device=streams.device)
    for t in range(T):
        cb, df, out[t] = p.step(cb, df, streams[t].long())
    return out.to(torch.int32)


def comb_states(streams, classmap, comb, def_table, k, owner_bits, root_base, root_def,
                overlap=None):
    """int32 [T, S]: the packed entry of the state each stream of
    ``streams`` ([T, S] uint8) enters at every step t, scanned from the
    root: its match count in bits 30..27, its base in bits 12..0.  With the
    stream plan's ``overlap`` the kernel may cut each stream into segments,
    each writing its own rows (``kernels/segments.py:stitch_segments``)."""
    check_comb(streams, classmap, comb, def_table, k, owner_bits, root_base, root_def)
    check_overlap(overlap)
    if on_cpu(streams):
        return comb_states_plain(streams, classmap, comb, def_table, k, owner_bits, root_base,
                                 root_def)
    T, S = streams.shape
    d = comb_count_design(streams, comb, def_table, overlap)
    out = torch.empty(T, S, dtype=torch.int32, device=streams.device)
    launch(
        "amt_comb_states", streams.device,
        streams.data_ptr(), T, S,
        classmap.data_ptr(), comb.data_ptr(), comb.numel(), def_table.data_ptr(),
        def_table.numel(), k, owner_bits, root_base, root_def, overlap or 0, d.segments,
        out.data_ptr(),
    )
    comb_states.launches += 1
    return out


#: Kernel launches since the last reset (CPU calls do not count).
comb_count.launches = 0
comb_contains.launches = 0
comb_states.launches = 0

__all__ = [
    "PlainComb",
    "check_comb",
    "comb_contains",
    "comb_contains_plain",
    "comb_count",
    "comb_count_design",
    "comb_count_plain",
    "comb_states",
    "comb_states_plain",
]
