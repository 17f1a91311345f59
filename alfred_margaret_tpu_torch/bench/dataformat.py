"""Benchmark data files (reference-compatible) and synthetic corpora.

The reference's files are "needles, one per line; blank line; haystack",
encoded UTF-16LE without BOM (``benchmark/README.md:20-33``); the reader
takes that encoding and a UTF-8 variant.  The port's copy of
``alfred_margaret_tpu/bench/dataformat.py`` (``tests/test_torch_host.py``
pins every function to the original).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def parse_bench_file(path: str) -> Tuple[List[str], str]:
    """Returns (needles, haystack)."""
    with open(path, "rb") as f:
        raw = f.read()
    text = None
    for enc in ("utf-16-le", "utf-8"):
        try:
            text = raw.decode(enc)
            # UTF-16LE decode of UTF-8 data "succeeds" with garbage; sanity
            # check that newlines survived.
            if "\n" in text:
                break
            text = None
        except UnicodeDecodeError:
            continue
    if text is None:
        raise ValueError(f"cannot decode {path} as UTF-16LE or UTF-8")
    text = text.replace("\r\n", "\n")
    needle_part, _, haystack = text.partition("\n\n")
    needles = [n for n in needle_part.split("\n") if n]
    return needles, haystack


def write_bench_file(path: str, needles: List[str], haystack: str, encoding: str = "utf-8") -> None:
    text = "\n".join(needles) + "\n\n" + haystack
    with open(path, "wb") as f:
        f.write(text.encode(encoding))


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


__all__ = ["parse_bench_file", "synth_corpus", "write_bench_file"]
