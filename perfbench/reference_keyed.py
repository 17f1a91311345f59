"""The plain reference for many needles: every occurrence, counted by key.

The same count as ``reference.count``: the number of pairs (needle, offset)
at which the needle's bytes occur in the text, overlapping occurrences and
nested needles included, a needle listed twice counted twice.  It makes one
pass per distinct needle length, not one per needle, so a set of a thousand
needles costs a handful of passes.

In blocks (each reads ``longest needle - 1`` bytes past its end, so that an
occurrence across a block's end is counted once, by the block it starts
in), the bytes from every offset are read as a little-endian int64 (zero
past the view's end).  For a needle length ``L``, the first ``min(L, 8)``
bytes of each offset, masked, are looked up among that length's needle
keys (``torch.searchsorted`` over the sorted distinct first words); a
needle of more than 8 bytes also compares the rest of its bytes, a masked
word each 8 bytes on, at the offsets whose first word matched, with every
needle of that length that shares the first word.  Every comparison
is exact; nothing is hashed.  Each distinct needle carries its
multiplicity.  It imports nothing of the program.

``cut`` gives the control, as in ``reference.count``: the same count in
independent blocks of ``cut`` bytes with nothing read past a block's end,
so that every occurrence across a cut is lost.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional, Sequence

import numpy as np
import torch

#: Bytes looked up per block on the device (about 40 bytes of device memory
#: a byte of text while a block is worked).
BLOCK_BYTES = 64 << 20

#: Bytes of one packed word.
WORD = 8


def _packed(b: bytes) -> int:
    """``b`` (at most 8 bytes) as a little-endian int64 (two's complement)."""
    v = int.from_bytes(b, "little")
    return v - (1 << 64) if v >= 1 << 63 else v


def _mask(length: int) -> int:
    return -1 if length >= WORD else (1 << (8 * length)) - 1


class _Keys:
    """The needles of one length ``L``: their first words sorted, the
    further words of each needle (``rest[c - 1]``, the bytes from ``8 c``)
    and its multiplicity beside it, and the longest run of needles that
    share a first word."""

    def __init__(self, length: int, needles: Counter, device):
        words = -(-length // WORD)
        rows = sorted(tuple(_packed(nd[c * WORD : (c + 1) * WORD]) for c in range(words)) + (k,)
                      for nd, k in needles.items())
        self.length = length
        table = torch.tensor(rows, dtype=torch.int64, device=device)
        self.first = table[:, 0].contiguous()
        self.rest = table[:, 1:-1].T.contiguous()
        self.mult = table[:, -1].contiguous()
        self.run = max(Counter(r[0] for r in rows).values())


def count(data, needles: Sequence[bytes], device, *, block: int = BLOCK_BYTES,
          cut: Optional[int] = None) -> int:
    """Occurrences of ``needles`` in ``data`` (bytes or a uint8 array; see
    the module docstring)."""
    n = len(data)
    longest = max(len(nd) for nd in needles)
    by_len = {}
    for nd, k in Counter(bytes(nd) for nd in needles).items():
        by_len.setdefault(len(nd), Counter())[nd] = k
    keys = [_Keys(length, group, device) for length, group in sorted(by_len.items())]
    host = np.frombuffer(data, dtype=np.uint8)
    total = 0
    for a in range(0, n, block):
        b = min(n, a + block)
        view = torch.from_numpy(host[a : min(n, b + longest - 1)].copy()).to(device)
        # word[i]: the 8 bytes from offset a + i, zero past the view's end,
        # for every start of the block and as far on as the longest needle.
        span = b - a + longest
        padded = torch.zeros(span + WORD, dtype=torch.int64, device=view.device)
        padded[: view.numel()] = view.long()
        del view
        word = torch.zeros(span, dtype=torch.int64, device=padded.device)
        for j in range(WORD):
            word |= padded[j : j + span] << (8 * j)
        del padded
        for ks in keys:
            k = min(b, n - ks.length + 1) - a  # starts at which the length fits
            if k <= 0:
                continue
            head = word[:k] & _mask(ks.length)
            lo = torch.searchsorted(ks.first, head)
            found = ks.first[lo.clamp(max=ks.first.numel() - 1)] == head
            pos = torch.nonzero(found).squeeze(1)
            if cut is not None:  # the control: only starts whose needle ends inside its cut
                pos = pos[(pos + a) % cut <= cut - ks.length]
            if pos.numel() == 0:
                continue
            lo = lo[pos]
            rest = [word[pos + c * WORD] & _mask(ks.length - c * WORD)
                    for c in range(1, 1 + ks.rest.shape[0])]
            for r in range(ks.run):  # each needle that shares the first word
                idx = lo + r
                ok = idx < ks.first.numel()
                idx = idx.clamp(max=ks.first.numel() - 1)
                ok &= ks.first[idx] == head[pos]
                for c, got in enumerate(rest):
                    ok &= ks.rest[c][idx] == got
                total += int(ks.mult[idx][ok].sum())
    return total


__all__ = ["BLOCK_BYTES", "WORD", "count"]
