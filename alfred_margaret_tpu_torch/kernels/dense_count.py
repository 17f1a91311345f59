"""B1 ``dense_count``: per-stream match counts of the packed byte-class DFA,
and B5 ``dense_states``: its packed entry at every step.

Wrappers of ``csrc/dense_count.cu``, which replaces the Pallas kernels
``alfred_margaret_tpu/ops/pallas_scan.py:_make_count_kernel`` (B1) and
``_make_states_kernel`` (B5).  A CUDA tensor launches the kernel; a CPU tensor
runs the plain version, the same function as a torch loop over time.  Nothing
falls back from one to the other.

With the stream plan's ``overlap`` both cut each stream into segments: a
block scans 128 streams of one segment from the root ``overlap`` bytes early,
bytes staged a tile of 32 steps ahead and translated to classes in place.
B1's segments add their counts (``kernels/segments.py:run_segments``), B5's
each write the rows of their own range (``kernels/segments.py:
stitch_segments``), exact while the overlap brings a restarted scan into the
stream's state, which ``DenseTables.check_overlap`` checks for the callers.
"""

from __future__ import annotations

import torch

from .common import check_overlap, check_packed, check_streams, check_tables, launch, on_cpu
from .segments import Design, dense_bits_smem_bytes, pick_segments, sm_count

#: Table words the kernels hold in shared memory (kMaxTableWords in the .cu):
#: MAX_ROWS rows of 128 entries.
MAX_TABLE_WORDS = 48 * 128


def check_dense(streams, classmap, table, packing, state_bits, **vectors):
    """The checks of the dense kernels (B1, B3, B6's dense step): streams,
    the packed table and class map, and ``[S]`` vectors such as ``warm``."""
    _, S = check_streams(streams)
    check_packed(table, packing, state_bits, MAX_TABLE_WORDS)
    check_tables(streams.device, {
        "classmap": (classmap, (256,)), "table": (table, (table.numel(),)),
        **{name: (x, (S,)) for name, x in vectors.items()},
    })


def lookup_plain(tab, idx, packing: int):
    """Packed entries at flat entry indices ``idx`` of ``tab`` (the table as
    int64 masked to its unsigned 32-bit words): one entry per word, or two
    16-bit entries per word, low half first."""
    if packing == 1:
        return tab[idx]
    return (tab[idx >> 1] >> ((idx & 1) << 4)) & 0xFFFF


def dense_count_plain(streams, classmap, table, warm, vend, packing: int, state_bits: int,
                      overlap=None):
    """Plain torch version of the kernel: one gather chain per time step.
    (``overlap`` only lets the kernel cut the streams into segments.)"""
    T, S = streams.shape
    dev = streams.device
    cm = classmap.long()
    tab = table.long() & 0xFFFFFFFF  # entries are unsigned
    mask = (1 << state_bits) - 1
    warm, vend = warm.long(), vend.long()
    sbase = torch.zeros(S, dtype=torch.int64, device=dev)
    counts = torch.zeros(S, dtype=torch.int64, device=dev)
    for t in range(T):
        v = lookup_plain(tab, sbase + cm[streams[t].long()], packing)
        sbase = v & mask
        live = (warm <= t) & (t < vend)
        counts += torch.where(live, v >> state_bits, 0)
    return counts.to(torch.int32)


def dense_count_design(streams, table, overlap=None) -> Design:
    """The segments ``dense_count`` cuts these CUDA streams into for
    ``table`` (``kernels/segments.py:pick_segments`` with the kernel's shared
    memory)."""
    T, S = streams.shape
    return Design(pick_segments(S, T, overlap, dense_bits_smem_bytes(table.numel()),
                                sm_count(streams.device)))


def dense_count(streams, classmap, table, warm, vend, packing: int, state_bits: int,
                overlap=None):
    """int32 [S] counts of the matches ending at t in [warm[s], vend[s]) of
    each stream of ``streams`` ([T, S] uint8), scanned from the root.

    ``classmap`` [256] maps bytes to classes; ``table`` holds the packed
    entries ``count << state_bits | next_state * k`` (``packing`` 1: one per
    int32, 2: two 16-bit entries per int32, low half first).  With the
    stream plan's ``overlap`` the kernel may cut each stream into segments;
    without, it scans each whole."""
    check_dense(streams, classmap, table, packing, state_bits, warm=warm, vend=vend)
    check_overlap(overlap)
    if on_cpu(streams):
        return dense_count_plain(streams, classmap, table, warm, vend, packing, state_bits)
    T, S = streams.shape
    d = dense_count_design(streams, table, overlap)
    out = torch.zeros(S, dtype=torch.int32, device=streams.device)
    launch(
        "amt_dense_count", streams.device,
        streams.data_ptr(), T, S,
        classmap.data_ptr(), table.data_ptr(), table.numel(),
        warm.data_ptr(), vend.data_ptr(), packing, state_bits, overlap or 0, d.segments,
        out.data_ptr(),
    )
    dense_count.launches += 1
    return out


def dense_states_plain(streams, classmap, table, packing: int, state_bits: int, overlap=None):
    """Plain torch version of B5: the entry of every step.  (``overlap``
    only lets the kernel cut the streams into segments.)"""
    T, S = streams.shape
    cm = classmap.long()
    tab = table.long() & 0xFFFFFFFF
    mask = (1 << state_bits) - 1
    sbase = torch.zeros(S, dtype=torch.int64, device=streams.device)
    out = torch.empty(T, S, dtype=torch.int64, device=streams.device)
    for t in range(T):
        out[t] = lookup_plain(tab, sbase + cm[streams[t].long()], packing)
        sbase = out[t] & mask
    return out.to(torch.int32)


#: Steps of B5's shortest segment (four tiles).  A shorter one spends more on
#: its restart and its block's table load than the extra blocks gain: on a
#: mesh shard of 640 steps (S7), k = 4 took 0.031 ms and B1's k = 16 0.042
#: (``PERF.md`` section 6).
MIN_STATES_SEGMENT_STEPS = 128


def dense_states_design(streams, table, overlap=None) -> Design:
    """The segments ``dense_states`` cuts these CUDA streams into for
    ``table``: B1's rule, with the same shared memory, but no segment shorter
    than ``MIN_STATES_SEGMENT_STEPS``."""
    k = dense_count_design(streams, table, overlap).segments
    return Design(max(1, min(k, streams.shape[0] // MIN_STATES_SEGMENT_STEPS)))


def dense_states(streams, classmap, table, packing: int, state_bits: int, overlap=None):
    """int32 [T, S]: the packed entry ``count << state_bits | next_state * k``
    of the state each stream of ``streams`` ([T, S] uint8) enters at every
    step t, scanned from the root with no emission window (packing 2: the
    16-bit entry, zero-extended).  With the stream plan's ``overlap`` the
    kernel may cut each stream into segments, each writing the rows of its
    own range; without, it scans each whole."""
    check_dense(streams, classmap, table, packing, state_bits)
    check_overlap(overlap)
    if on_cpu(streams):
        return dense_states_plain(streams, classmap, table, packing, state_bits)
    T, S = streams.shape
    d = dense_states_design(streams, table, overlap)
    out = torch.empty(T, S, dtype=torch.int32, device=streams.device)
    launch(
        "amt_dense_states", streams.device,
        streams.data_ptr(), T, S,
        classmap.data_ptr(), table.data_ptr(), table.numel(), packing, state_bits, overlap or 0,
        d.segments, out.data_ptr(),
    )
    dense_states.launches += 1
    return out


#: Kernel launches since the last reset (CPU calls do not count).
dense_count.launches = 0
dense_states.launches = 0

__all__ = ["dense_count", "dense_count_design", "dense_count_plain", "dense_states",
           "dense_states_design", "dense_states_plain", "lookup_plain"]
