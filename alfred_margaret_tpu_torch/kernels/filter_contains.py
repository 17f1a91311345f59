"""B14 ``filter_contains``: the stride-2 screen's two planes per stream.

Wrapper of ``csrc/filter_contains.cu``, which replaces the Pallas kernel
``alfred_margaret_tpu/ops/filter_scan.py:make_filter_contains_kernel``.  A
CUDA tensor launches the kernel; a CPU tensor runs
:func:`filter_contains_plain`.  Nothing falls back from one to the other.

One step per byte pair ``(b1, b2) = (streams[2u], streams[2u + 1])`` while
``2u < vend``, with ``h = ((b1 & 15) << 3) | (b2 & 7)``:

    D[v] = ((D[v] << 1) | seed[v]) & btab[v][h];   cand |= D[v] & endmask[v]
    roll = (roll << 16) | (b1 << 8) | b2
    exact |= any over shorts k of ((roll & mask[k]) == const[k])
                                or (((roll >> 8) & mask[k]) == const[k])

From ``2u >= vend`` on the registers and ``roll`` are frozen, so the planes no
longer change and the scan stops.  Output ``[2, S]``: ``exact`` (0 or 1) and
``cand`` (the OR of every word's end bits).

With the layout's ``restart`` (``FilterTables.restart``: the bytes a scan
restarted from the root needs before it is in step) and the stream plan's
``overlap``, the kernel cuts each stream into segments at even steps
(``kernels/segments.py:planes_over_segments``): a block scans 128 streams of
one segment from ``restart`` bytes before its own range, bytes staged a tile
of 32 steps ahead, and ORs its planes into the output.
"""

from __future__ import annotations

import torch

from .common import check_overlap, check_streams, check_tables, launch, on_cpu
from .segments import Design, filter_smem_bytes, pick_segments, sm_count

#: Candidate words and short needles the kernel holds (kMaxWords and
#: kMaxShorts in the .cu): the grouped engine plans up to 12 words, the
#: comb16 engine up to 3, and the planner takes at most MAX_SHORTS shorts.
MAX_WORDS = 12
MAX_SHORTS = 8


def _check(streams, vend, btab, seed, endmask, short_mask, short_const):
    T, S = check_streams(streams)
    V, K = seed.numel(), short_mask.numel()
    if V > MAX_WORDS or K > MAX_SHORTS:
        raise ValueError(f"{V} words and {K} shorts; the kernel holds {MAX_WORDS} and {MAX_SHORTS}")
    if T % 2:
        raise ValueError(f"T = {T} time steps; the screen steps over byte pairs")
    check_tables(streams.device, {
        "vend": (vend, (S,)), "btab": (btab, (V, 128)), "seed": (seed, (V,)),
        "endmask": (endmask, (V,)), "short_mask": (short_mask, (K,)),
        "short_const": (short_const, (K,)),
    })


def check_restart(restart, overlap) -> None:
    """Raise ``ValueError`` unless ``restart`` (None, or an even number of
    bytes >= 2) is at most the stream plan's ``overlap + 1`` rounded up to
    even: a plan that warms each stream over fewer bytes than the layout
    needs was made for other needles."""
    check_overlap(overlap)
    if restart is None:
        return
    if restart < 2 or restart % 2:
        raise ValueError(f"restart must be an even number of bytes >= 2, got {restart}")
    if overlap is not None and restart > (overlap + 2) // 2 * 2:
        raise ValueError(f"the layout needs a restart of {restart} bytes; the plan's overlap "
                         f"{overlap} warms each stream over only {overlap + 1}")


def filter_contains_plain(streams, vend, btab, seed, endmask, short_mask, short_const,
                          restart=None, overlap=None):
    """Plain torch version of the kernel: one pair step per two time steps,
    the registers frozen where ``2u >= vend``.  (``restart`` and ``overlap``
    only let the kernel cut the streams into segments.)"""
    T, S = streams.shape
    dev = streams.device
    bt = btab.long() & 0xFFFFFFFF
    sd = (seed.long() & 0xFFFFFFFF).unsqueeze(1)
    em = (endmask.long() & 0xFFFFFFFF).unsqueeze(1)
    sm = (short_mask.long() & 0xFFFFFFFF).unsqueeze(1)
    sc = (short_const.long() & 0xFFFFFFFF).unsqueeze(1)
    vend = vend.long()
    V = seed.numel()
    D = torch.zeros(V, S, dtype=torch.int64, device=dev)
    roll = torch.zeros(S, dtype=torch.int64, device=dev)
    exact = torch.zeros(S, dtype=torch.int64, device=dev)
    cand = torch.zeros(S, dtype=torch.int64, device=dev)
    rows = torch.arange(V, device=dev).unsqueeze(1)
    for u in range(T // 2):
        adv = 2 * u < vend
        b1, b2 = streams[2 * u].long(), streams[2 * u + 1].long()
        h = ((b1 & 15) << 3) | (b2 & 7)
        nd = (((D << 1) | sd) & bt[rows, h.unsqueeze(0)]) & 0xFFFFFFFF
        D = torch.where(adv, nd, D)
        cand |= _or0(D & em)
        roll = torch.where(adv, ((roll << 16) | (b1 << 8) | b2) & 0xFFFFFFFF, roll)
        if short_mask.numel():
            hit = ((roll & sm) == sc) | (((roll >> 8) & sm) == sc)
            exact |= hit.any(0).long()
    return torch.stack([exact, cand]).to(torch.int32)


def _or0(x):
    """Bitwise OR over the first axis of an int64 tensor (zeros when empty)."""
    out = torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device)
    for row in x:
        out |= row
    return out


def filter_contains_design(streams, btab, restart=None, overlap=None) -> Design:
    """The segments ``filter_contains`` cuts these CUDA streams into for
    ``btab``'s words: ``pick_segments`` with the kernel's shared memory, one
    segment without a restart or an overlap, never a segment no longer than
    the restart."""
    T, S = streams.shape
    if restart is None or overlap is None:
        return Design(1)
    smem = filter_smem_bytes(btab.shape[0])
    return Design(pick_segments(S, T, restart, smem, sm_count(streams.device)))


def filter_contains(streams, vend, btab, seed, endmask, short_mask, short_const, restart=None,
                    overlap=None):
    """int32 ``[2, S]``: per stream of ``streams`` ([T, S] uint8, T even),
    whether a short needle ended in ``[0, vend]`` (plane 0, 0 or 1) and the
    OR of the candidate end bits (plane 1).  ``btab`` [V, 128], ``seed`` and
    ``endmask`` [V] are the candidate words, ``short_mask`` and
    ``short_const`` [K] the short needles (V <= 12, K <= 8).  With the
    layout's ``restart`` and the stream plan's ``overlap`` the kernel may cut
    each stream into segments (``check_restart`` holds the two together);
    without either, it scans each whole."""
    _check(streams, vend, btab, seed, endmask, short_mask, short_const)
    check_restart(restart, overlap)
    if on_cpu(streams):
        return filter_contains_plain(streams, vend, btab, seed, endmask, short_mask, short_const)
    T, S = streams.shape
    d = filter_contains_design(streams, btab, restart, overlap)
    out = torch.zeros(2, S, dtype=torch.int32, device=streams.device)
    launch(
        "amt_filter_contains", streams.device,
        streams.data_ptr(), T, S, vend.data_ptr(),
        btab.data_ptr(), seed.data_ptr(), endmask.data_ptr(), seed.numel(),
        short_mask.data_ptr(), short_const.data_ptr(), short_mask.numel(), restart or 2,
        d.segments, out.data_ptr(),
    )
    filter_contains.launches += 1
    return out


#: Kernel launches since the last reset (CPU calls do not count).
filter_contains.launches = 0

__all__ = [
    "check_restart",
    "filter_contains",
    "filter_contains_design",
    "filter_contains_plain",
]
