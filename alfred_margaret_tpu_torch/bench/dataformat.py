"""Synthetic benchmark corpora.

The port's copy of ``synth_corpus`` from
``alfred_margaret_tpu/bench/dataformat.py`` (``tests/test_torch_host.py``
pins it to the original), for ``chip_smoke.py`` and the tests.
"""

from __future__ import annotations

from typing import List

import numpy as np


def synth_corpus(
    needles: List[str], size_bytes: int, hit_fraction: float = 0.01, seed: int = 0
) -> bytes:
    """A corpus of random words with the needles sprinkled in: a word is a
    needle with probability ``hit_fraction``."""
    rng = np.random.default_rng(seed)
    filler = [
        "".join(chr(97 + c) for c in rng.integers(0, 26, size=rng.integers(3, 10)))
        for _ in range(200)
    ]
    n_words = min(max(64, size_bytes // 6), 100_000)
    is_needle = rng.random(n_words) < hit_fraction
    fill_idx = rng.integers(0, len(filler), size=n_words)
    needle_idx = rng.integers(0, max(1, len(needles)), size=n_words)
    if not needles:
        is_needle[:] = False
    words = [
        (needles[needle_idx[i]] if is_needle[i] else filler[fill_idx[i]])
        for i in range(n_words)
    ]
    block = " ".join(words).encode("utf-8")
    reps = size_bytes // len(block) + 1
    return (block * reps)[:size_bytes]


__all__ = ["synth_corpus"]
