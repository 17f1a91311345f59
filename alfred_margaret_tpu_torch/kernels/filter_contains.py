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
"""

from __future__ import annotations

import torch

from .common import check_streams, check_tables, launch, on_cpu

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


def filter_contains_plain(streams, vend, btab, seed, endmask, short_mask, short_const):
    """Plain torch version of the kernel: one pair step per two time steps,
    the registers frozen where ``2u >= vend``."""
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


def filter_contains(streams, vend, btab, seed, endmask, short_mask, short_const):
    """int32 ``[2, S]``: per stream of ``streams`` ([T, S] uint8, T even),
    whether a short needle ended in ``[0, vend]`` (plane 0, 0 or 1) and the
    OR of the candidate end bits (plane 1).  ``btab`` [V, 128], ``seed`` and
    ``endmask`` [V] are the candidate words, ``short_mask`` and
    ``short_const`` [K] the short needles (V <= 12, K <= 8)."""
    _check(streams, vend, btab, seed, endmask, short_mask, short_const)
    if on_cpu(streams):
        return filter_contains_plain(streams, vend, btab, seed, endmask, short_mask, short_const)
    T, S = streams.shape
    out = torch.empty(2, S, dtype=torch.int32, device=streams.device)
    launch(
        "amt_filter_contains", streams.device,
        streams.data_ptr(), T, S, vend.data_ptr(),
        btab.data_ptr(), seed.data_ptr(), endmask.data_ptr(), seed.numel(),
        short_mask.data_ptr(), short_const.data_ptr(), short_mask.numel(), out.data_ptr(),
    )
    filter_contains.launches += 1
    return out


#: Kernel launches since the last reset (CPU calls do not count).
filter_contains.launches = 0

__all__ = ["filter_contains", "filter_contains_plain"]
