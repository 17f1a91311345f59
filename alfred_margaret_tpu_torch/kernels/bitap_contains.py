"""B4 ``bitap_contains`` and B7 ``bitap_presence``: sticky end bits of V
shift-AND registers per stream.

Wrappers of ``csrc/bitap_contains.cu``, which replaces the Pallas kernels
``alfred_margaret_tpu/ops/bitap_scan.py:_make_bitap_contains_kernel`` (B4:
one hit register per stream) and ``_make_bitap_presence_kernel`` (B7: one
sticky plane per word), for layouts without a trap register.  A CUDA tensor
launches the kernel; a CPU tensor runs the plain torch version.  Nothing
falls back from one to the other.
"""

from __future__ import annotations

import torch

from .common import check_streams, check_tables, launch, on_cpu

#: Registers per stream the kernels support (kMaxWords in the .cu): the
#: ``max_words`` default of ``plan_bitap``.
MAX_WORDS = 3


def _check(streams, btab, seed, endmask):
    if btab.dim() != 2 or btab.shape[1] != 256:
        raise ValueError("btab must be [V, 256]")
    V = btab.shape[0]
    if not 1 <= V <= MAX_WORDS:
        raise ValueError(f"V = {V} words; the kernel takes 1..{MAX_WORDS}")
    check_streams(streams)
    check_tables(streams.device, {"btab": (btab, (V, 256)), "seed": (seed, (V,)),
                                  "endmask": (endmask, (V,))})
    return V


def sticky_planes_plain(streams, btab, seed, endmask):
    """Plain torch version of both kernels: int64 ``[V, S]`` OR over every
    step of ``D[w] & endmask[w]``, with ``D[w] = ((D[w] << 1) | seed[w]) &
    btab[w, byte]``.  No step is masked: warm-up bytes are real corpus
    bytes, and the zero pads clear the registers."""
    T, S = streams.shape
    bt = btab.long()
    sd = seed.long().unsqueeze(1)
    em = endmask.long().unsqueeze(1)
    D = torch.zeros(btab.shape[0], S, dtype=torch.int64, device=streams.device)
    H = torch.zeros_like(D)
    for t in range(T):
        D = ((D << 1) | sd) & bt[:, streams[t].long()]
        H |= D & em
    return H


def bitap_contains_plain(streams, btab, seed, endmask):
    """Plain torch version of :func:`bitap_contains`."""
    H = sticky_planes_plain(streams, btab, seed, endmask)
    hits = H[0]
    for w in range(1, H.shape[0]):
        hits = hits | H[w]
    return hits.to(torch.int32)


def bitap_presence_plain(streams, btab, seed, endmask):
    """Plain torch version of :func:`bitap_presence`."""
    return sticky_planes_plain(streams, btab, seed, endmask).to(torch.int32)


def bitap_contains(streams, btab, seed, endmask):
    """int32 ``[S]``: per stream, the OR over all steps and words of
    ``D[w] & endmask[w]``; non-zero iff some needle ends in the stream
    (warm-up bytes included)."""
    V = _check(streams, btab, seed, endmask)
    if on_cpu(streams):
        return bitap_contains_plain(streams, btab, seed, endmask)
    T, S = streams.shape
    out = torch.empty(S, dtype=torch.int32, device=streams.device)
    launch("amt_bitap_contains", streams.device, streams.data_ptr(), T, S,
           btab.data_ptr(), seed.data_ptr(), endmask.data_ptr(), V, out.data_ptr())
    bitap_contains.launches += 1
    return out


def bitap_presence(streams, btab, seed, endmask):
    """int32 ``[V, S]``: per word and stream, the OR over all steps of
    ``D[w] & endmask[w]``.  Each set end bit flags its track's needle; the
    words stay apart because they share bit positions."""
    V = _check(streams, btab, seed, endmask)
    if on_cpu(streams):
        return bitap_presence_plain(streams, btab, seed, endmask)
    T, S = streams.shape
    out = torch.empty(V, S, dtype=torch.int32, device=streams.device)
    launch("amt_bitap_presence", streams.device, streams.data_ptr(), T, S,
           btab.data_ptr(), seed.data_ptr(), endmask.data_ptr(), V, out.data_ptr())
    bitap_presence.launches += 1
    return out


#: Kernel launches since the last reset (CPU calls do not count).
bitap_contains.launches = 0
bitap_presence.launches = 0

__all__ = [
    "bitap_contains",
    "bitap_contains_plain",
    "bitap_presence",
    "bitap_presence_plain",
]
