"""B3 ``dense_contains``: the final entry of the sticky (absorbing) DFA per stream.

Wrapper of ``csrc/dense_contains.cu``, which replaces the Pallas kernel
``alfred_margaret_tpu/ops/pallas_scan.py:_make_contains_kernel``.  A CUDA
tensor launches the kernel; a CPU tensor runs :func:`dense_contains_plain`,
the same function as a torch loop over time.  Nothing falls back from one to
the other.
"""

from __future__ import annotations

from typing import Optional

import torch

from .common import launch, on_cpu
from .dense_count import check_dense, lookup_plain


def dense_contains_plain(streams, classmap, table, vend, packing: int, state_bits: int,
                         absorb: int, s0: int = 0, s1: Optional[int] = None):
    """Plain torch version of the kernel: one gather chain per time step,
    the state held where ``t >= vend``.  (``absorb`` only lets the kernel
    stop early; the plain version scans every step.)"""
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


def dense_contains(streams, classmap, table, vend, packing: int, state_bits: int,
                   absorb: int, s0: int = 0, s1: Optional[int] = None):
    """int32 ``[s1 - s0]``: the final sticky entry (``state * k``) of streams
    ``s0 .. s1 - 1`` of ``streams`` ([T, S] uint8), scanned from the root
    over ``t < vend[s]``.  A stream saw a match iff its entry is ``absorb``
    (the absorbing state times k).  ``classmap`` and ``table`` are the
    sticky view's packed tables, laid out as for ``dense_count``."""
    check_dense(streams, classmap, table, packing, state_bits, vend=vend)
    T, S = streams.shape
    s1 = S if s1 is None else s1
    if not 0 <= s0 < s1 <= S:
        raise ValueError(f"stream range [{s0}, {s1}) outside [0, {S})")
    if on_cpu(streams):
        return dense_contains_plain(streams, classmap, table, vend, packing, state_bits,
                                    absorb, s0, s1)
    out = torch.empty(s1 - s0, dtype=torch.int32, device=streams.device)
    launch(
        "amt_dense_contains", streams.device,
        streams.data_ptr(), T, S,
        classmap.data_ptr(), table.data_ptr(), table.numel(), vend.data_ptr(),
        packing, state_bits, absorb, s0, s1, out.data_ptr(),
    )
    dense_contains.launches += 1
    return out


#: Kernel launches since the last reset (CPU calls do not count).
dense_contains.launches = 0

__all__ = ["dense_contains", "dense_contains_plain"]
