"""B4 ``bitap_contains`` and B7 ``bitap_presence``: sticky end bits of V
shift-AND registers per stream.

Wrappers of the kernels that replace the Pallas kernels
``alfred_margaret_tpu/ops/bitap_scan.py:_make_bitap_contains_kernel`` (B4:
one hit register per stream) and ``_make_bitap_presence_kernel`` (B7: one
sticky plane per word), with their trap parts: given a ``trapmask``
(IgnoreCase byte-class layouts), B4 also returns a sticky trap flag per
stream and B7 ORs the trap bits into each word's plane.  Both are modes of
B2's segmented scan, ``csrc/bitap_count.cu`` (B4 the sticky mode, B7 the
presence mode).  A CUDA tensor launches the kernel; a CPU tensor runs the
plain torch version.  Nothing falls back from one to the other.

With the stream plan's ``overlap`` both cut each stream into segments, as
B2 does (``kernels/segments.py:or_over_segments``): a block scans 128
streams of one segment, its registers restarted ``overlap`` bytes early,
bytes staged a tile of 32 steps ahead, and ORs every step it scans into
its hit (B4) or each word's plane (B7).  That is exact while every track,
match or trap, is at most ``overlap + 1`` bytes long, which
``BitapTables.check_overlap`` checks for the callers.  Without an overlap
a stream is one segment.
"""

from __future__ import annotations

import torch

from .common import check_overlap, check_streams, check_tables, launch, on_cpu
from .segments import Design, bitap_smem_bytes, pick_segments, sm_count

#: Registers per stream the kernels support (kMaxTrapWords in
#: ``bitap_count.cu``): the ``max_words`` default of ``plan_bitap``, and the
#: 2-word budget plus a standalone trap register.
MAX_WORDS = 3


def _check(streams, btab, seed, endmask, trapmask):
    if btab.dim() != 2 or btab.shape[1] != 256:
        raise ValueError("btab must be [V, 256]")
    V = btab.shape[0]
    if not 1 <= V <= MAX_WORDS:
        raise ValueError(f"V = {V} words; the kernel takes 1..{MAX_WORDS}")
    check_streams(streams)
    tables = {"btab": (btab, (V, 256)), "seed": (seed, (V,)), "endmask": (endmask, (V,))}
    if trapmask is not None:
        tables["trapmask"] = (trapmask, (V,))
    check_tables(streams.device, tables)
    return V


def sticky_planes_plain(streams, btab, seed, endmask, trapmask=None):
    """Plain torch version of both kernels: int64 ``[V, S]`` OR over every
    step of ``D[w] & endmask[w]``, with ``D[w] = ((D[w] << 1) | seed[w]) &
    btab[w, byte]``, and with ``trapmask`` also the ``[V, S]`` OR of ``D[w] &
    trapmask[w]``.  No step is masked: warm-up bytes are real corpus bytes,
    and the zero pads clear the registers."""
    T, S = streams.shape
    bt = btab.long()
    sd = seed.long().unsqueeze(1)
    em = endmask.long().unsqueeze(1)
    D = torch.zeros(btab.shape[0], S, dtype=torch.int64, device=streams.device)
    H = torch.zeros_like(D)
    if trapmask is not None:
        tm = trapmask.long().unsqueeze(1)
        tr = torch.zeros_like(D)
    for t in range(T):
        D = ((D << 1) | sd) & bt[:, streams[t].long()]
        H |= D & em
        if trapmask is not None:
            tr |= D & tm
    return H if trapmask is None else (H, tr)


def _or_words(planes):
    out = planes[0]
    for w in range(1, planes.shape[0]):
        out = out | planes[w]
    return out.to(torch.int32)


def bitap_contains_plain(streams, btab, seed, endmask, trapmask=None, overlap=None):
    """Plain torch version of :func:`bitap_contains`.  (``overlap`` only lets
    the kernel cut the streams into segments.)"""
    if trapmask is None:
        return _or_words(sticky_planes_plain(streams, btab, seed, endmask))
    H, tr = sticky_planes_plain(streams, btab, seed, endmask, trapmask)
    return _or_words(H), _or_words(tr)


def bitap_presence_plain(streams, btab, seed, endmask, trapmask=None, overlap=None):
    """Plain torch version of :func:`bitap_presence`.  (``overlap`` only lets
    the kernel cut the streams into segments.)"""
    if trapmask is None:
        return sticky_planes_plain(streams, btab, seed, endmask).to(torch.int32)
    H, tr = sticky_planes_plain(streams, btab, seed, endmask, trapmask)
    return (H | tr).to(torch.int32)


def bitap_contains_design(streams, btab, overlap=None) -> Design:
    """The segments ``bitap_contains`` and ``bitap_presence`` cut these CUDA
    streams into for ``btab``'s words (``kernels/segments.py:pick_segments``
    with B2's shared memory and no count fields)."""
    T, S = streams.shape
    smem = bitap_smem_bytes(btab.shape[0], 0)
    return Design(pick_segments(S, T, overlap, smem, sm_count(streams.device)))


#: B7 shares B4's shared memory and so its rule.
bitap_presence_design = bitap_contains_design


def bitap_contains(streams, btab, seed, endmask, trapmask=None, overlap=None):
    """int32 ``[S]``: per stream, the OR over all steps and words of
    ``D[w] & endmask[w]``; non-zero iff some needle ends in the stream
    (warm-up bytes included).  With ``trapmask`` (int32 ``[V]``), returns
    ``(hits, trap)``, trap the same OR of ``D[w] & trapmask[w]``.

    With the stream plan's ``overlap`` (at least the longest track less one)
    the kernel may cut each stream into segments; without, it scans each
    whole."""
    V = _check(streams, btab, seed, endmask, trapmask)
    check_overlap(overlap)
    if on_cpu(streams):
        return bitap_contains_plain(streams, btab, seed, endmask, trapmask)
    T, S = streams.shape
    d = bitap_contains_design(streams, btab, overlap)
    out = torch.zeros(S, dtype=torch.int32, device=streams.device)
    args = (streams.data_ptr(), T, S, btab.data_ptr(), seed.data_ptr(), endmask.data_ptr())
    if trapmask is None:
        launch("amt_bitap_contains", streams.device, *args, V, overlap or 0, d.segments,
               out.data_ptr())
        bitap_contains.launches += 1
        return out
    trap = torch.zeros(S, dtype=torch.int32, device=streams.device)
    launch("amt_bitap_contains_trap", streams.device, *args, trapmask.data_ptr(), V,
           overlap or 0, d.segments, out.data_ptr(), trap.data_ptr())
    bitap_contains.launches += 1
    bitap_contains.launches_trap += 1
    return out, trap


def bitap_presence(streams, btab, seed, endmask, trapmask=None, overlap=None):
    """int32 ``[V, S]``: per word and stream, the OR over all steps of
    ``D[w] & endmask[w]`` (``D[w] & (endmask[w] | trapmask[w])`` with a
    ``trapmask``).  Each set end bit flags its track's needle; the words
    stay apart because they share bit positions.

    With the stream plan's ``overlap`` (at least the longest track less one)
    the kernel may cut each stream into segments; without, it scans each
    whole."""
    V = _check(streams, btab, seed, endmask, trapmask)
    check_overlap(overlap)
    if on_cpu(streams):
        return bitap_presence_plain(streams, btab, seed, endmask, trapmask)
    T, S = streams.shape
    d = bitap_presence_design(streams, btab, overlap)
    out = torch.zeros(V, S, dtype=torch.int32, device=streams.device)
    args = (streams.data_ptr(), T, S, btab.data_ptr(), seed.data_ptr(), endmask.data_ptr())
    if trapmask is None:
        launch("amt_bitap_presence", streams.device, *args, V, overlap or 0, d.segments,
               out.data_ptr())
    else:
        launch("amt_bitap_presence_trap", streams.device, *args, trapmask.data_ptr(), V,
               overlap or 0, d.segments, out.data_ptr())
        bitap_presence.launches_trap += 1
    bitap_presence.launches += 1
    return out


#: Kernel launches since the last reset (CPU calls do not count), in all and
#: with the trap part.
bitap_contains.launches = 0
bitap_contains.launches_trap = 0
bitap_presence.launches = 0
bitap_presence.launches_trap = 0

__all__ = [
    "bitap_contains",
    "bitap_contains_design",
    "bitap_contains_plain",
    "bitap_presence",
    "bitap_presence_design",
    "bitap_presence_plain",
]
