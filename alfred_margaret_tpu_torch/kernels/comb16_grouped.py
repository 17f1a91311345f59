"""B9 ``comb16_count_grouped`` and B11 ``comb16_contains_grouped``: the fused
comb16 scans over G needle groups in one launch; and B11's one-group mode,
``comb16_contains_base``, the sharded engine's comb16 sticky step.

Wrappers of ``csrc/comb16_grouped.cu``, which replaces the Pallas kernels
``alfred_margaret_tpu/ops/comb16_scan.py:_make_c16_count_kernel_dyn`` (B9)
and ``_make_c16_contains_kernel_dyn`` (B11: ``n_groups > 1``, and with
``n_groups == 1`` its final-base mode).  A CUDA
tensor launches the kernel; a CPU tensor runs the plain torch version.
Nothing falls back from one to the other.

The tables are an ``ops.comb16_scan.Comb16GroupTables``: per group g a class
map ``classmap[g]`` [256], ``comb[g]`` and ``aux[g]`` (16-bit entry pairs,
zero rows padding every group to the widest), ``root_row[g]`` and
``segtable[g]`` [128], and the scalars ``gscal[g]``; the field split
``BB``, ``owner_mask`` and ``CB`` is one for all groups.  Group g steps as
B8 and B10 do (``kernels/comb16.py``) from its root base ``gscal[g, 0]``:

* B9 sums over the groups the counts of the matches ending at ``t`` in
  ``[warm[s], vend[s])``, group g's count ranges being ``gscal[g, 1:]``
  (padded with ``2**BB``);
* B11 is 1 where some group's base, held from ``vend[s]`` on, is its
  absorbing base ``gscal[g, 1]``, else 0;
* B11's one-group mode (G = 1) is that final base itself, as the TPU kernel
  writes it for the sharded engine, which compares it with ``gscal[0, 1]``
  outside the kernel.

All three run one scan of ``csrc/comb16_grouped.cu`` in three compile-time
modes: with the stream plan's ``overlap`` it cuts each stream into segments
and the groups into chunks (``kernels/segments.py``, whose helpers combine
the plain versions' per-segment results as the kernel does).
"""

from __future__ import annotations

import torch

from .comb16 import MAX_TABLE_WORDS, N_RANGES, check_split
from .common import check_overlap, check_streams, check_tables, launch, on_cpu
from .segments import Design, grouped_design, sm_count


def _check(streams, tables, sticky: bool, **vectors) -> None:
    _, S = check_streams(streams)
    if bool(tables.sticky) != sticky:
        raise ValueError("B9 takes count tables, B11 sticky ones (Comb16GroupTables.sticky)")
    G = tables.classmap.shape[0] if tables.classmap.dim() == 2 else 0
    cw = tables.comb.shape[1] if tables.comb.dim() == 2 else 0
    aw = tables.aux.shape[1] if tables.aux.dim() == 2 else 0
    if G < 1 or cw < 1 or aw < 1:
        raise ValueError("the group tables must be [G, ...] with G >= 1 and non-empty rows")
    if cw + aw > MAX_TABLE_WORDS:
        raise ValueError(f"comb and aux hold {cw + aw} words a group; "
                         f"the kernels hold at most {MAX_TABLE_WORDS}")
    check_split(tables.BB, tables.owner_mask, tables.CB)
    width = tables.gscal.shape[1] if tables.gscal.dim() == 2 else 0
    if not (width == 2 if sticky else 1 <= width <= 1 + N_RANGES):
        raise ValueError(f"gscal of width {width} for {'B11' if sticky else 'B9'}")
    if len(tables.gscal_host) != G or any(len(row) != width for row in tables.gscal_host):
        raise ValueError(f"gscal_host must hold gscal's {G} rows of {width}")
    check_tables(streams.device, {
        "classmap": (tables.classmap, (G, 256)), "comb": (tables.comb, (G, cw)),
        "aux": (tables.aux, (G, aw)), "root_row": (tables.root_row, (G, 128)),
        "segtable": (tables.segtable, (G, 128)), "gscal": (tables.gscal, (G, width)),
        **{name: (x, (S,)) for name, x in vectors.items()},
    })


class _PlainGroups:
    """The stacked tables as int64 tensors, and one lookup step of every
    group over every stream at once (``[G, S]`` bases): the plain version
    shared by B9 and B11, each group's tables indexed at its own offset in
    the flattened stack (the step of ``kernels.comb16.Plain16`` per group)."""

    def __init__(self, tables):
        G = tables.classmap.shape[0]
        dev = tables.classmap.device
        self.cm = tables.classmap.long().reshape(-1)
        self.comb = tables.comb.long().reshape(-1) & 0xFFFFFFFF  # entries are unsigned
        self.aux = tables.aux.long().reshape(-1) & 0xFFFFFFFF
        self.root = tables.root_row.long().reshape(-1)
        self.seg = tables.segtable.long().reshape(-1)
        g = torch.arange(G, dtype=torch.int64, device=dev).unsqueeze(1)  # [G, 1]
        self.off_cm, self.off_rs = g * 256, g * 128
        self.off_comb = g * tables.comb.shape[1]
        self.off_aux = g * tables.aux.shape[1]
        self.BB, self.om = tables.BB, tables.owner_mask

    def entry(self, cb, b):
        """The 16-bit entries for bases ``cb`` [G, S] on bytes ``b`` [S]."""
        cls = self.cm[self.off_cm + b.unsqueeze(0)]
        w1 = cb + cls
        e1 = (self.comb[self.off_comb + (w1 >> 1)] >> ((w1 & 1) << 4)) & 0xFFFF
        cbv = self.seg[self.off_rs + (cb >> (self.BB - 7))]
        w2 = cbv + cls
        e2 = (self.aux[self.off_aux + (w2 >> 1)] >> ((w2 & 1) << 4)) & 0xFFFF
        hit1 = ((e1 >> self.BB) & self.om) == (cb & self.om)
        hit2 = ((e2 >> self.BB) & self.om) == (cbv & self.om)
        return torch.where(hit1, e1, torch.where(hit2, e2, self.root[self.off_rs + cls]))


def comb16_count_grouped_plain(streams, warm, vend, tables, overlap=None):
    """Plain torch version of B9: every group's B8 scan at once, one lookup
    per time step, the counts of ``warm <= t < vend`` summed over groups.
    (``overlap`` only lets the kernel cut the streams into segments.)"""
    T, S = streams.shape
    p = _PlainGroups(tables)
    bmask = (1 << tables.BB) - 1
    gscal = tables.gscal.long()
    ranges = gscal[:, 1:].unsqueeze(2)  # [G, n_ranges, 1]
    warm, vend = warm.long(), vend.long()
    cb = gscal[:, :1].expand(-1, S).clone()
    counts = torch.zeros(S, dtype=torch.int64, device=streams.device)
    for t in range(T):
        e = p.entry(cb, streams[t].long())
        cb = e & bmask
        if tables.CB:
            cnt = ((e >> 15) & 1) + (cb.unsqueeze(1) >= ranges).sum(1)
            counts += torch.where((warm <= t) & (t < vend), cnt.sum(0), 0)
    return counts.to(torch.int32)


def comb16_count_grouped(streams, warm, vend, tables, overlap=None):
    """int32 [S]: per stream of ``streams`` ([T, S] uint8), the matches of
    every group ending at t in [warm[s], vend[s]), summed over the groups of
    ``tables`` (an ``ops.comb16_scan.Comb16GroupTables`` of count tables).
    With the stream plan's ``overlap`` the kernel may cut each stream into
    segments (``kernels/segments.py``); without, it scans each whole."""
    _check(streams, tables, False, warm=warm, vend=vend)
    check_overlap(overlap)
    if on_cpu(streams):
        return comb16_count_grouped_plain(streams, warm, vend, tables)
    T, S = streams.shape
    d = comb16_grouped_design(streams, tables, overlap)
    out = torch.zeros(S, dtype=torch.int32, device=streams.device)
    launch(
        "amt_comb16_count_grouped", streams.device,
        streams.data_ptr(), T, S, warm.data_ptr(), vend.data_ptr(), tables.n_groups,
        tables.classmap.data_ptr(), tables.comb.data_ptr(), tables.comb.shape[1],
        tables.aux.data_ptr(), tables.aux.shape[1], tables.root_row.data_ptr(),
        tables.segtable.data_ptr(), tables.gscal.data_ptr(), tables.gscal.shape[1],
        tables.BB, tables.owner_mask, tables.CB, overlap or 0, d.segments, d.chunk,
        out.data_ptr(),
    )
    comb16_count_grouped.launches += 1
    return out



def comb16_grouped_design(streams, tables, overlap=None) -> Design:
    """The segments and the groups per block that B9, B11 and B11's
    one-group mode launch with for these CUDA streams and tables."""
    T, S = streams.shape
    return grouped_design(S, T, overlap, tables.n_groups, tables.comb.shape[1],
                          tables.aux.shape[1], sm_count(streams.device))


def comb16_contains_grouped_plain(streams, vend, tables, overlap=None):
    """Plain torch version of B11: every group's B10 scan at once, the base
    held where ``t >= vend``; 1 where some group ends on its absorbing base.
    (``overlap`` only lets the kernel cut the streams into segments.)"""
    T, S = streams.shape
    p = _PlainGroups(tables)
    bmask = (1 << tables.BB) - 1
    gscal = tables.gscal.long()
    vend = vend.long()
    cb = gscal[:, :1].expand(-1, S).clone()
    for t in range(T):
        cb = torch.where(t < vend, p.entry(cb, streams[t].long()) & bmask, cb)
    return (cb == gscal[:, 1:2]).any(0).to(torch.int32)


def comb16_contains_grouped(streams, vend, tables, overlap=None):
    """int32 [S]: 1 where a needle of some group of ``tables`` (an
    ``ops.comb16_scan.Comb16GroupTables`` of sticky tables) ends in
    ``[0, vend[s])`` of stream s of ``streams`` ([T, S] uint8), else 0.
    With the stream plan's ``overlap`` the kernel may cut each stream into
    segments (``kernels/segments.py:any_over_segments``)."""
    _check(streams, tables, True, vend=vend)
    check_overlap(overlap)
    if on_cpu(streams):
        return comb16_contains_grouped_plain(streams, vend, tables)
    T, S = streams.shape
    d = comb16_grouped_design(streams, tables, overlap)
    out = torch.zeros(S, dtype=torch.int32, device=streams.device)
    launch(
        "amt_comb16_contains_grouped", streams.device,
        streams.data_ptr(), T, S, vend.data_ptr(), tables.n_groups,
        tables.classmap.data_ptr(), tables.comb.data_ptr(), tables.comb.shape[1],
        tables.aux.data_ptr(), tables.aux.shape[1], tables.root_row.data_ptr(),
        tables.segtable.data_ptr(), tables.gscal.data_ptr(), tables.BB, tables.owner_mask,
        overlap or 0, d.segments, d.chunk, out.data_ptr(),
    )
    comb16_contains_grouped.launches += 1
    return out


def comb16_contains_base_plain(streams, vend, tables, overlap=None):
    """Plain torch version of B11's one-group mode: the B10 scan of the one
    group, the base held where ``t >= vend``.  (``overlap`` only lets the
    kernel cut the streams into segments.)"""
    p = _PlainGroups(tables)
    bmask = (1 << tables.BB) - 1
    vend = vend.long()
    cb = tables.gscal.long()[:, :1].expand(-1, streams.shape[1]).clone()
    for t in range(streams.shape[0]):
        cb = torch.where(t < vend, p.entry(cb, streams[t].long()) & bmask, cb)
    return cb[0].to(torch.int32)


def comb16_contains_base(streams, vend, tables, overlap=None):
    """int32 [S]: the final base of each stream of ``streams`` ([T, S]
    uint8), scanned from the root base ``gscal[0, 0]`` over ``t < vend[s]``
    with the sticky tables of ``tables``, a one-group
    ``ops.comb16_scan.Comb16GroupTables``.  A stream saw a match iff its base
    is the absorbing base ``gscal[0, 1]``; a stream with ``vend`` 0 keeps the
    root base.  With the stream plan's ``overlap`` the kernel may cut each
    stream into segments (``kernels/segments.py:base_over_segments``).  It
    launches B10's kernel, the two bases (``gscal_host``) as arguments."""
    _check(streams, tables, True, vend=vend)
    if tables.n_groups != 1:
        raise ValueError(f"B11's one-group mode takes one group, got {tables.n_groups}")
    check_overlap(overlap)
    if on_cpu(streams):
        return comb16_contains_base_plain(streams, vend, tables)
    T, S = streams.shape
    d = comb16_grouped_design(streams, tables, overlap)
    root, absorb = tables.gscal_host[0]
    out = torch.empty(S, dtype=torch.int32, device=streams.device)  # the root base, in the launch
    launch(
        "amt_comb16_contains", streams.device,
        streams.data_ptr(), T, S, vend.data_ptr(),
        tables.classmap.data_ptr(), tables.comb.data_ptr(), tables.comb.shape[1],
        tables.aux.data_ptr(), tables.aux.shape[1], tables.root_row.data_ptr(),
        tables.segtable.data_ptr(), tables.BB, tables.owner_mask, root, absorb, overlap or 0,
        d.segments, out.data_ptr(),
    )
    comb16_contains_base.launches += 1
    return out


#: Kernel launches since the last reset (CPU calls do not count).
comb16_count_grouped.launches = 0
comb16_contains_grouped.launches = 0
comb16_contains_base.launches = 0

__all__ = [
    "comb16_contains_base",
    "comb16_contains_base_plain",
    "comb16_contains_grouped",
    "comb16_contains_grouped_plain",
    "comb16_count_grouped",
    "comb16_count_grouped_plain",
    "comb16_grouped_design",
]
