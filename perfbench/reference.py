"""The plain reference: every occurrence of every needle, counted.

The semantics the configurations state for ``count_matches``: the number of
pairs (needle, offset) at which the needle's bytes occur in the text,
overlapping occurrences and nested needles included, at any byte offset.
It is worked out again from the bytes the benchmark made, with plain torch
comparisons in blocks (each block reads ``longest needle - 1`` bytes past
its end, so that an occurrence across a block's end is counted once, by
the block it starts in).  A needle of at most 8 bytes occurs at an offset
iff the bytes there, read as a little-endian integer and cut to the
needle's length, equal the needle read the same way: one comparison a
needle.  A longer needle is compared byte by byte.  It imports nothing of
the program.

``cut`` gives the control: the same count, computed in independent blocks
of ``cut`` bytes with nothing read past a block's end, so that every
occurrence across a cut is lost.  It breaks the stated guarantee that
occurrences are counted at any offset, which is what a scan that drops its
stream warm-up or its chunk prefix would do.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

#: Bytes compared per block on the device (eight int64 a byte while packed).
BLOCK_BYTES = 64 << 20

#: Needles up to this many bytes are compared as one packed integer.
WORD = 8


def _packed(nd: bytes) -> int:
    """``nd`` as a little-endian int64 (two's complement)."""
    v = int.from_bytes(nd, "little")
    return v - (1 << 64) if v >= 1 << 63 else v


def _mask(length: int) -> int:
    return -1 if length == WORD else (1 << (8 * length)) - 1


def count(data, needles: Sequence[bytes], device, *, block: int = BLOCK_BYTES,
          cut: Optional[int] = None) -> int:
    """Occurrences of ``needles`` in ``data`` (bytes or a uint8 array; see
    the module docstring)."""
    n = len(data)
    longest = max(len(nd) for nd in needles)
    short = sorted((nd for nd in needles if len(nd) <= WORD), key=len)
    long = [nd for nd in needles if len(nd) > WORD]
    host = np.frombuffer(data, dtype=np.uint8)
    total = 0
    for a in range(0, n, block):
        b = min(n, a + block)
        view = torch.from_numpy(host[a : min(n, b + longest - 1)].copy()).to(device)
        if cut is not None:  # each start's offset inside its block of the control
            offset = (torch.arange(a, b, dtype=torch.int64, device=view.device) % cut).int()

        def fits(nd: bytes) -> int:  # starts of this block at which ``nd`` fits
            return min(b, n - len(nd) + 1) - a

        def kept(hit: torch.Tensor, nd: bytes) -> torch.Tensor:
            return hit if cut is None else hit & (offset[: hit.numel()] <= cut - len(nd))

        if short:
            # word[i]: the 8 bytes from offset i, zero past the view's end.
            padded = torch.zeros(view.numel() + WORD, dtype=torch.int64, device=view.device)
            padded[: view.numel()] = view.long()
            word = torch.zeros(b - a, dtype=torch.int64, device=view.device)
            for j in range(min(WORD, len(short[-1]))):
                word |= padded[j : j + b - a] << (8 * j)
            masked_len, masked = 0, word
            for nd in short:
                k = fits(nd)
                if k <= 0:
                    continue
                if len(nd) != masked_len:
                    masked_len, masked = len(nd), word & _mask(len(nd))
                total += int(kept(masked[:k] == _packed(nd), nd).sum())
            del padded, word, masked
        for nd in long:
            k = fits(nd)
            if k <= 0:
                continue
            hit = view[:k] == nd[0]
            for j in range(1, len(nd)):
                hit &= view[j : j + k] == nd[j]
            total += int(kept(hit, nd).sum())
    return total


def naive_count(data: bytes, needles: Sequence[bytes]) -> int:
    """``bytes.find`` over every offset: the reference of the reference."""
    total = 0
    for nd in needles:
        i = data.find(nd)
        while i >= 0:
            total += 1
            i = data.find(nd, i + 1)
    return total


__all__ = ["BLOCK_BYTES", "WORD", "count", "naive_count"]
