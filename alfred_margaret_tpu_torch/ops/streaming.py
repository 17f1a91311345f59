"""Out-of-core streaming scans: corpora larger than the device budget (or
larger than a safe one-shot transfer) in fixed-size chunks with exact
results.

A copy of ``alfred_margaret_tpu/ops/streaming.py``, with the port's spans
(``utils.trace.span``) around each chunk, its host slice and its cold-prefix
replay.  The device engines
stage whole corpora on the card; past ``2 * AMT_STREAM_CHUNK_MB``
(``MatchEngine._stream_scanner``) each chunk is staged and scanned
independently instead (constant device memory), and exactness comes from
the automaton's bounded history:

* every chunk after the first is scanned with a ``W = max_needle_bytes - 1``
  byte *prefix* from the previous chunk, so every match crossing the
  boundary is seen by exactly the later chunk's scan (the same overlap
  argument as the in-chunk stream decomposition);
* matches ending INSIDE the prefix were already counted by the previous
  chunk; their count is recomputed exactly on the host from the W prefix
  bytes (a from-root replay, as the chunk's own scan starts from the root)
  and subtracted.

Positions re-base by the chunk's global offset; chunks are processed in
order so the concatenated match list stays in global emission order.
``contains`` early-exits at the first hitting chunk.

Engines: anything with ``stage``, ``count_staged``, ``contains_staged`` and
``matches_arrays_staged``: the port's bitap, dense, comb16, comb32 and
grouped engines and the mesh's ``DistributedAcEngine``.  Sources: anything
sliceable with a length over bytes: ``bytes``, ``np.ndarray``, ``np.memmap``
(the 10 GB+ path: chunks are read lazily, and the host holds one chunk at a
time).
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

from ..models.ac import AcMachine
from ..utils import trace, utf8


def _slice_u8(source, a: int, b: int) -> np.ndarray:
    if isinstance(source, (bytes, bytearray, memoryview)):
        return np.frombuffer(source[a:b], dtype=np.uint8)
    return np.asarray(source[a:b], dtype=np.uint8)


def _cold_prefix_count(machine: AcMachine, window: np.ndarray) -> int:
    """What the device chunk scan emitted over its prefix region: a
    from-ROOT scalar replay of exactly the prefix bytes.  This mirrors the
    chunk's own cold start bit-for-bit (matches straddling into the prefix
    from before it are invisible to both — the previous chunk counted
    them), so subtracting it removes precisely the double-counted ends."""
    with trace.span("amt.stream.cold_prefix"):
        delta = machine.delta
        mc = machine.match_count
        state = 0
        total = 0
        for b in memoryview(utf8.to_bytes(window)):
            state = delta[state, b]
            total += int(mc[state])
        return total


class StreamingScanner:
    """Chunked scans over any staged-capable engine (bitap / dense / comb16 /
    comb32 / grouped / the mesh: anything with ``stage`` + ``count_staged``)."""

    def __init__(self, engine, machine: AcMachine, chunk_bytes: int = 64 << 20):
        if chunk_bytes < 4 * max(1, machine.max_needle_bytes):
            raise ValueError("chunk_bytes too small for the needle window")
        self.engine = engine
        self.machine = machine
        self.chunk_bytes = int(chunk_bytes)
        self.W = max(0, machine.max_needle_bytes - 1)

    def _chunks(self, n: int) -> Iterator[Tuple[int, int]]:
        a = 0
        while a < n:
            yield a, min(n, a + self.chunk_bytes)
            a += self.chunk_bytes

    def _stage_chunk(self, source, a: int, b: int):
        pre = max(0, a - self.W)
        with trace.span("amt.stage.host"):
            data = _slice_u8(source, pre, b)
        eng = self.engine
        st = eng.stage(data) if hasattr(eng, "stage") else eng._stage(data)
        return st, pre

    def count(self, source) -> int:
        n = len(source)
        total = 0
        for a, b in self._chunks(n):
            with trace.span("amt.stream.chunk"):
                st, pre = self._stage_chunk(source, a, b)
                total += self.engine.count_staged(st)
                if pre < a:
                    # Subtract what this chunk's cold start emitted over the
                    # W-byte prefix (already counted by the previous chunk).
                    total -= _cold_prefix_count(self.machine, _slice_u8(source, pre, a))
        return total

    def contains(self, source) -> bool:
        n = len(source)
        for a, b in self._chunks(n):
            with trace.span("amt.stream.chunk"):
                st, _ = self._stage_chunk(source, a, b)
                if self.engine.contains_staged(st):
                    return True  # chunk-granular early exit
        return False

    def matches_arrays(self, source) -> Tuple[np.ndarray, np.ndarray]:
        n = len(source)
        all_ends = []
        all_vids = []
        eng = self.engine
        for a, b in self._chunks(n):
            with trace.span("amt.stream.chunk"):
                st, pre = self._stage_chunk(source, a, b)
                # Every staged-capable engine (dense/comb/comb16/grouped/mesh)
                # exposes matches_arrays_staged; extraction reuses the chunk
                # upload from _stage_chunk rather than re-staging.
                ends, vids = eng.matches_arrays_staged(st)
                ends = ends + pre
                keep = ends > a  # drop prefix-region duplicates (ends <= a)
                all_ends.append(ends[keep])
                all_vids.append(vids[keep])
        if not all_ends:
            return np.zeros(0, np.int64), np.zeros(0, np.int32)
        return (
            np.concatenate(all_ends).astype(np.int64),
            np.concatenate(all_vids).astype(np.int32),
        )


__all__ = ["StreamingScanner"]
