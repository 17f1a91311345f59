"""The benchmark's text generator: words drawn whole from a seed.

A corpus is words of ``word_min`` to ``word_max`` letters ``a``-``z`` (each
length equally likely), separated by single spaces; each word is, with
probability ``hit_fraction``, one of the configuration's needles instead
(each needle equally likely).  Nothing repeats: every letter, length and
choice is drawn afresh, so the corpus has no short block that comes back.

This rewrites ``alfred_margaret_tpu_torch/bench/dataformat.py:synth_corpus``
(which repeats one block of at most 100,000 words) and keeps its draw: a
word is a needle with probability ``hit_fraction`` (``bench.py`` and
``bench/configs.py`` use 0.01).  The draw runs on ``device`` in a few large
calls from one ``torch.Generator``, so that 1 GiB takes well under a second
on the card.  The same seed on the same device type gives the same bytes;
the CPU and the card give different bytes for one seed.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

#: Words drawn per call: enough that a GiB takes a dozen calls, few enough
#: that their index arrays stay small.
WORDS_PER_CALL = 1 << 24

SPACE = 0x20


def stream_seed(seed: int, index: int) -> int:
    """A 63-bit generator seed for document ``index`` of a run's ``seed``."""
    return int(np.random.SeedSequence([int(seed), int(index)]).generate_state(1, np.uint64)[0]
               >> np.uint64(1))


def generate(n_bytes: int, needles: Sequence[bytes], seed: int, *, hit_fraction: float,
             word_min: int, word_max: int, device) -> torch.Tensor:
    """``n_bytes`` bytes of text on ``device`` (uint8), drawn from ``seed``."""
    if not 1 <= word_min <= word_max:
        raise ValueError("need 1 <= word_min <= word_max")
    if not needles or any(len(nd) == 0 for nd in needles):
        raise ValueError("needles must be non-empty byte strings")
    device = torch.device(device)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    width = max(len(nd) for nd in needles)
    table = torch.zeros((len(needles), width), dtype=torch.uint8)
    for i, nd in enumerate(needles):
        table[i, : len(nd)] = torch.tensor(list(nd), dtype=torch.uint8)
    table = table.to(device)
    needle_len = torch.tensor([len(nd) for nd in needles], dtype=torch.int64, device=device)

    shortest = min(word_min, int(needle_len.min())) + 1  # a word and its space
    buf = torch.randint(ord("a"), ord("z") + 1, (n_bytes,), dtype=torch.uint8,
                        device=device, generator=g)
    start = 0  # where the next call's first word begins
    while start < n_bytes:
        n = min(WORDS_PER_CALL, (n_bytes - start) // shortest + 1)
        lengths = torch.randint(word_min, word_max + 1, (n,), device=device, generator=g)
        is_needle = torch.rand((n,), device=device, generator=g) < hit_fraction
        which = torch.randint(0, len(needles), (n,), device=device, generator=g)
        lengths = torch.where(is_needle, needle_len[which], lengths)
        ends = torch.cumsum(lengths + 1, 0) + (start - 1)  # each word's space
        starts = ends - lengths
        spaces = ends[ends < n_bytes]
        buf[spaces] = SPACE
        hit = torch.nonzero(is_needle & (starts < n_bytes)).squeeze(1)
        for j in range(width):
            sel = hit[needle_len[which[hit]] > j]
            pos = starts[sel] + j
            keep = pos < n_bytes
            buf[pos[keep]] = table[which[sel[keep]], j]
        start = int(ends[-1]) + 1
    return buf


def to_host_bytes(buf: torch.Tensor) -> bytes:
    """The generated bytes as one host ``bytes`` object."""
    return buf.cpu().numpy().tobytes()


__all__ = ["generate", "stream_seed", "to_host_bytes", "WORDS_PER_CALL"]
