"""B2 ``bitap_count``: per-stream match counts of V shift-AND registers.

Wrapper of ``csrc/bitap_count.cu``, which replaces the Pallas kernel
``alfred_margaret_tpu/ops/bitap_scan.py:_make_bitap_count_kernel`` for
layouts without a trap register.  A CUDA tensor launches the kernel; a CPU
tensor runs :func:`bitap_count_plain`, the same function as a torch loop over
time.  Nothing falls back from one to the other.
"""

from __future__ import annotations

import torch

from .common import check_streams, check_tables, launch, on_cpu

#: Registers per stream the kernel supports (kMaxWords in the .cu).
MAX_WORDS = 8
#: Count fields the kernel holds in shared memory (kMaxFields in the .cu).
MAX_FIELDS = MAX_WORDS * 30


def _check_inputs(streams, btab, seed, endmask, field_start, field_bit, field_weight, warm):
    _, S = check_streams(streams)
    if btab.dim() != 2 or btab.shape[1] != 256:
        raise ValueError("btab must be [V, 256]")
    V, F = btab.shape[0], field_bit.numel()
    if not 1 <= V <= MAX_WORDS:
        raise ValueError(f"V = {V} words; the kernel takes 1..{MAX_WORDS}")
    if F > MAX_FIELDS:
        raise ValueError(f"{F} fields; the kernel takes at most {MAX_FIELDS}")
    check_tables(streams.device, {
        "btab": (btab, (V, 256)),
        "seed": (seed, (V,)),
        "endmask": (endmask, (V,)),
        "field_start": (field_start, (V + 1,)),
        "field_bit": (field_bit, (F,)),
        "field_weight": (field_weight, (F,)),
        "warm": (warm, (S,)),
    })


def bitap_count_plain(streams, btab, seed, endmask, field_start, field_bit, field_weight, warm):
    """Plain torch version of the kernel: V register updates per time step."""
    T, S = streams.shape
    V = btab.shape[0]
    dev = streams.device
    bt = btab.long()
    sd = seed.long().unsqueeze(1)
    starts = field_start.tolist()
    word_of = torch.cat(
        [torch.full((starts[w + 1] - starts[w],), w, dtype=torch.int64) for w in range(V)]
    ).to(dev)
    fbit = field_bit.long().unsqueeze(1)
    fwt = field_weight.long().unsqueeze(1)
    warm = warm.long()
    D = torch.zeros(V, S, dtype=torch.int64, device=dev)
    counts = torch.zeros(S, dtype=torch.int64, device=dev)
    for t in range(T):
        D = ((D << 1) | sd) & bt[:, streams[t].long()]
        hits = ((D[word_of] >> fbit) & 1) * fwt  # [F, S]
        counts += torch.where(warm <= t, hits.sum(0), 0)
    return counts.to(torch.int32)


def bitap_count(streams, btab, seed, endmask, field_start, field_bit, field_weight, warm):
    """int32 [S] counts of the matches ending at t >= warm[s] of each stream of
    ``streams`` ([T, S] uint8; right-pad bytes must be zero).

    Word w's register steps ``D = ((D << 1) | seed[w]) & btab[w, byte]``; its
    count fields are ``field_bit``/``field_weight`` [field_start[w],
    field_start[w + 1]) and ``endmask[w]`` is the OR of their end bits."""
    _check_inputs(streams, btab, seed, endmask, field_start, field_bit, field_weight, warm)
    if on_cpu(streams):
        return bitap_count_plain(
            streams, btab, seed, endmask, field_start, field_bit, field_weight, warm
        )
    T, S = streams.shape
    out = torch.empty(S, dtype=torch.int32, device=streams.device)
    launch(
        "amt_bitap_count", streams.device,
        streams.data_ptr(), T, S,
        btab.data_ptr(), seed.data_ptr(), endmask.data_ptr(),
        field_start.data_ptr(), field_bit.data_ptr(), field_weight.data_ptr(),
        btab.shape[0], field_bit.numel(), warm.data_ptr(), out.data_ptr(),
    )
    bitap_count.launches += 1
    return out


#: Kernel launches since the last reset (CPU calls do not count).
bitap_count.launches = 0

__all__ = ["bitap_count", "bitap_count_plain"]
