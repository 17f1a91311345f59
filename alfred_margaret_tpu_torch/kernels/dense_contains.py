"""B3 ``dense_contains``: the final entry of the sticky (absorbing) DFA per stream.

Wrapper of the kernel that replaces the Pallas kernel
``alfred_margaret_tpu/ops/pallas_scan.py:_make_contains_kernel``: the
sticky mode of B1's segmented scan (``csrc/dense_count.cu``).  A CUDA tensor
launches the kernel; a CPU tensor runs :func:`dense_contains_plain`, the same
function as a torch loop over time.  Nothing falls back from one to the
other.

With the stream plan's ``overlap`` the kernel cuts each stream into segments
(``kernels/segments.py:entry_over_segments``): a block scans 128 streams of
one segment from the root ``overlap`` bytes early up to ``min(p_{y+1},
vend)``, bytes staged a tile of 32 steps ahead and translated to classes in
place.  The segments combine exactly: ``absorb`` where one of them absorbed
(an absorb is a real match in ``[0, vend)``), else the entry of the segment
whose own range holds step ``vend - 1``, else the root's.  That holds while
a scan restarted ``overlap`` bytes early is in the stream's state by its
own range, which ``StickyTables.check_overlap`` checks for the callers.
"""

from __future__ import annotations

from typing import Optional

import torch

from .common import check_overlap, launch, on_cpu
from .dense_count import check_dense, lookup_plain
from .segments import Design, dense_bits_smem_bytes, pick_segments, sm_count


def dense_contains_plain(streams, classmap, table, vend, packing: int, state_bits: int,
                         absorb: int, s0: int = 0, s1: Optional[int] = None, overlap=None):
    """Plain torch version of the kernel: one gather chain per time step,
    the state held where ``t >= vend``.  (``absorb`` only lets the kernel
    stop early, and ``overlap`` cut the streams into segments; the plain
    version scans every step of each whole stream.)"""
    s1 = streams.shape[1] if s1 is None else s1
    cols = streams[:, s0:s1]
    cm = classmap.long()
    tab = table.long() & 0xFFFFFFFF
    mask = (1 << state_bits) - 1
    vend = vend[s0:s1].long()
    sbase = torch.zeros(s1 - s0, dtype=torch.int64, device=streams.device)
    for t in range(streams.shape[0]):
        v = lookup_plain(tab, sbase + cm[cols[t].long()], packing)
        sbase = torch.where(t < vend, v & mask, sbase)
    return sbase.to(torch.int32)


def dense_contains_design(streams, table, overlap=None, s0: int = 0,
                          s1: Optional[int] = None) -> Design:
    """The segments ``dense_contains`` cuts streams ``[s0, s1)`` of these
    CUDA streams into for ``table`` (``kernels/segments.py:pick_segments``
    at ``s1 - s0`` streams with B1's shared memory)."""
    T, S = streams.shape
    n = (S if s1 is None else s1) - s0
    return Design(pick_segments(n, T, overlap, dense_bits_smem_bytes(table.numel()),
                                sm_count(streams.device)))


def dense_contains(streams, classmap, table, vend, packing: int, state_bits: int,
                   absorb: int, s0: int = 0, s1: Optional[int] = None, overlap=None):
    """int32 ``[s1 - s0]``: the final sticky entry (``state * k``) of streams
    ``s0 .. s1 - 1`` of ``streams`` ([T, S] uint8), scanned from the root
    over ``t < vend[s]``.  A stream saw a match iff its entry is ``absorb``
    (the absorbing state times k).  ``classmap`` and ``table`` are the
    sticky view's packed tables, laid out as for ``dense_count``.  With the
    stream plan's ``overlap`` the kernel may cut each stream into segments;
    without, it scans each whole."""
    check_dense(streams, classmap, table, packing, state_bits, vend=vend)
    check_overlap(overlap)
    T, S = streams.shape
    s1 = S if s1 is None else s1
    if not 0 <= s0 < s1 <= S:
        raise ValueError(f"stream range [{s0}, {s1}) outside [0, {S})")
    if absorb < 0:
        raise ValueError(f"absorbing entry {absorb} is negative")
    if on_cpu(streams):
        return dense_contains_plain(streams, classmap, table, vend, packing, state_bits,
                                    absorb, s0, s1)
    d = dense_contains_design(streams, table, overlap, s0, s1)
    out = torch.zeros(s1 - s0, dtype=torch.int32, device=streams.device)  # the root entry
    launch(
        "amt_dense_contains", streams.device,
        streams.data_ptr(), T, S,
        classmap.data_ptr(), table.data_ptr(), table.numel(), vend.data_ptr(),
        packing, state_bits, absorb, s0, s1, overlap or 0, d.segments, out.data_ptr(),
    )
    dense_contains.launches += 1
    return out


#: Kernel launches since the last reset (CPU calls do not count).
dense_contains.launches = 0

__all__ = ["dense_contains", "dense_contains_design", "dense_contains_plain"]
