"""B6 ``matchbits``: exact masked counts and a one-bit-per-position hit
bitmap in one scan.

Wrapper of ``csrc/matchbits.cu``, which replaces the Pallas kernel
``alfred_margaret_tpu/ops/pallas_scan.py:make_matchbits_kernel`` with three
of its step families: the dense packed table (``dense_bits_step_factory``),
the one-word bitap register (``BitapAcEngine._bits_tables``) and the 16-bit
three-tier comb (``comb16_scan.py:_c16_bits_tables``, kernel B13).  A CUDA tensor
launches the kernel; a CPU tensor runs :func:`matchbits_plain`.  Nothing
falls back from one to the other.

``step`` names the family and ``tables`` its tables:

* ``"dense"``: ``(classmap, table, packing, state_bits)``, as for
  ``dense_count``;
* ``"bitap"``: ``(btab, seed, endmask, field_start, field_bit,
  field_weight)`` of a one-word layout, as for ``bitap_count``;
* ``"comb16"``: ``Comb16Tables.args()``, as for ``comb16_count``.
"""

from __future__ import annotations

import torch

from .comb16 import Plain16, check_comb16
from .common import check_streams, check_tables, launch, on_cpu
from .dense_count import check_dense, lookup_plain

#: Count fields of the one-word bitap step (kMaxWordFields in the .cu): one
#: per track bit of a word.
MAX_WORD_FIELDS = 30


def _check(streams, warm, vend, step, tables):
    if step == "dense":
        classmap, table, packing, state_bits = tables
        check_dense(streams, classmap, table, packing, state_bits, warm=warm, vend=vend)
    elif step == "bitap":
        btab, seed, endmask, field_start, field_bit, field_weight = tables
        _, S = check_streams(streams)
        F = field_bit.numel()
        if F > MAX_WORD_FIELDS:
            raise ValueError(f"{F} fields; one word holds at most {MAX_WORD_FIELDS}")
        check_tables(streams.device, {
            "btab": (btab, (1, 256)), "seed": (seed, (1,)), "endmask": (endmask, (1,)),
            "field_start": (field_start, (2,)), "field_bit": (field_bit, (F,)),
            "field_weight": (field_weight, (F,)), "warm": (warm, (S,)), "vend": (vend, (S,)),
        })
    elif step == "comb16":
        check_comb16(streams, *tables, warm=warm, vend=vend)
    else:
        raise ValueError(f"step must be 'dense', 'bitap' or 'comb16', got {step!r}")
    if streams.shape[0] % 32:
        raise ValueError(f"T = {streams.shape[0]} time steps; the kernel needs a multiple of 32")


def _to_int32(x):
    """int64 holding unsigned 32-bit words -> int32 of the same bits."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def matchbits_plain(streams, warm, vend, step: str, *tables):
    """Plain torch version of the kernel: one step of the family per time
    step, its count ``cnt`` added where ``warm <= t < vend`` and bit
    ``t % 32`` of word ``t // 32`` set where ``cnt > 0`` (at every t)."""
    T, S = streams.shape
    dev = streams.device
    carry = torch.zeros(S, dtype=torch.int64, device=dev)
    if step == "dense":
        classmap, table, packing, state_bits = tables
        cm = classmap.long()
        tab = table.long() & 0xFFFFFFFF
        mask = (1 << state_bits) - 1
    elif step == "comb16":
        c16 = Plain16(*tables[:-1])
        carry += tables[-1]  # the root base
    else:
        btab, seed, _, _, field_bit, field_weight = tables
        bt = btab[0].long()
        sd = int(seed[0])
        fbit = field_bit.long().unsqueeze(1)
        fwt = field_weight.long().unsqueeze(1)
    warm, vend = warm.long(), vend.long()
    counts = torch.zeros(S, dtype=torch.int64, device=dev)
    bits = torch.zeros(T // 32, S, dtype=torch.int64, device=dev)
    for t in range(T):
        b = streams[t].long()
        if step == "dense":
            v = lookup_plain(tab, carry + cm[b], packing)
            carry = v & mask
            cnt = v >> state_bits
        elif step == "comb16":
            carry, cnt = c16.step(carry, b)
        else:
            carry = ((carry << 1) | sd) & bt[b]
            cnt = (((carry.unsqueeze(0) >> fbit) & 1) * fwt).sum(0)
        bits[t >> 5] |= (cnt > 0).long() << (t & 31)
        counts += torch.where((warm <= t) & (t < vend), cnt, 0)
    return counts.to(torch.int32), _to_int32(bits)


def matchbits(streams, warm, vend, step: str, *tables):
    """``(counts, bits)`` of ``streams`` ([T, S] uint8, ``T % 32 == 0``),
    scanned from the root with the ``step`` family:

    * ``counts`` int32 ``[S]``: the matches ending at t in ``[warm[s],
      vend[s])``, exact;
    * ``bits`` int32 ``[T / 32, S]``: bit ``j`` of word ``w`` is set iff some
      match ends at ``t = 32 w + j``, unmasked, so warm-up duplicates and
      (for machines that are not zero-inert) pad hits are in it; the host
      expansion drops them.
    """
    _check(streams, warm, vend, step, tables)
    if on_cpu(streams):
        return matchbits_plain(streams, warm, vend, step, *tables)
    T, S = streams.shape
    counts = torch.empty(S, dtype=torch.int32, device=streams.device)
    bits = torch.empty(T // 32, S, dtype=torch.int32, device=streams.device)
    ptrs = (streams.data_ptr(), T, S, warm.data_ptr(), vend.data_ptr())
    outs = (counts.data_ptr(), bits.data_ptr())
    if step == "dense":
        classmap, table, packing, state_bits = tables
        launch("amt_matchbits_dense", streams.device, *ptrs,
               classmap.data_ptr(), table.data_ptr(), table.numel(), packing, state_bits, *outs)
    elif step == "bitap":
        btab, seed, endmask, _, field_bit, field_weight = tables
        launch("amt_matchbits_bitap", streams.device, *ptrs,
               btab.data_ptr(), seed.data_ptr(), endmask.data_ptr(),
               field_bit.data_ptr(), field_weight.data_ptr(), field_bit.numel(), *outs)
    else:
        classmap, comb, aux, root_row, segtable, ranges, BB, owner_mask, CB, root_cb = tables
        launch("amt_matchbits_comb16", streams.device, *ptrs,
               classmap.data_ptr(), comb.data_ptr(), comb.numel(), aux.data_ptr(), aux.numel(),
               root_row.data_ptr(), segtable.data_ptr(), ranges.data_ptr(),
               BB, owner_mask, CB, root_cb, *outs)
    matchbits.launches += 1
    return counts, bits


#: Kernel launches since the last reset (CPU calls do not count).
matchbits.launches = 0

__all__ = ["matchbits", "matchbits_plain"]
