"""The schedule of the segmented scans B1, B2, B3, B4, B5, B7, B8, B9, B10,
B11, B12, B15, B16, B17, the bitmap scans B6 and B13 and the stride-2 screen
B14 (every kernel of the port): how each stream is cut into segments and how
the groups of B9 and B11 are cut into chunks, the two numbers each launch
takes from its shapes.

``csrc/stage.cuh`` runs the same split on the card.  Segment i of ``k``
covers the steps ``[p_i, p_{i+1})``, ``p_i = i * T // k``; it scans from the
root starting ``overlap`` bytes early, at ``max(0, p_i - overlap)``.
``overlap`` is the stream plan's warm-up (``StreamPlan.overlap``,
``max_needle_bytes - 1``): a scan restarted from the root that has read
``overlap + 1`` bytes is in the state of the scan from the stream's start, as
between the streams of the plan.  So, per stream:

* a count (B1, B8, B9, B15) adds the steps t with ``max(p_i, warm[s]) <= t <
  min(p_{i+1}, vend[s])`` of every segment (:func:`run_segments`);
* B2, which has no ``vend``, adds the steps ``max(p_i, warm[s]) <= t <
  p_{i+1}`` and ORs its trap plane over every step each segment scans
  (:func:`bitap_over_segments`);
* B4, B2's sticky mode, ORs its hits and its trap plane over every step
  each segment scans, and B7, its presence mode, each word's plane
  (:func:`or_over_segments`): a restarted register holds a subset of the
  true bits, so every bit it sets is real, and it is in step over its own
  range;
* a sticky-any scan (B11) is the OR over segments of the scan of
  ``[max(0, p_i - overlap), min(p_{i+1}, vend[s]))`` (:func:`any_over_segments`):
  an absorb there is a real match in ``[0, vend)``, and every real match ends
  in some segment's own range, where that segment is in step;
* a sticky final entry (B3, B10, B11's one-group mode, B16) is the absorbing
  entry if some segment reached it, else the entry of the segment whose own
  range holds step ``vend[s] - 1``, else (``vend`` 0) the root's
  (:func:`entry_over_segments`, :func:`combine_bases`);
* the states (B5, B12, B17) are each segment's rows of its own range
  (:func:`stitch_segments`);
* the bitmap scans (B6, B13) cut at word boundaries instead
  (:func:`word_segment_schedule`): each segment's count is summed as B15's
  and the bitmap is each segment's words of its own range
  (:func:`bits_over_segments`);
* the screen (B14) steps over byte pairs, so it cuts at even steps
  (:func:`pair_segment_schedule`) and restarts a layout-derived even
  ``restart`` bytes early instead of ``overlap``: its two planes are the OR
  over segments (:func:`planes_over_segments`).

Without an overlap (``None``) a stream is one segment.  Nothing here needs a
card: the CPU tests run the plain versions over these schedules, and the
sizes mirror the sources'.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import torch

#: kMaxSegments and kMaxChunk of the sources.
MAX_SEGMENTS = 64
MAX_CHUNK = 16
#: Streams a block scans (kThreads, kRowBytes), and the steps of a staged
#: tile (kTile; two tiles a block).
BLOCK_STREAMS = 128
T_TILE = 32
#: The replicated class map (kRepWords) and a group's count-range slots.
REP_WORDS = 64 * 32
RANGE_SLOTS = 8
#: Shared memory an H100 block may take, and an SM holds (the CUDA runtime
#: reserves 1 KiB of each SM's 228 KiB per resident block).
SMEM_PER_BLOCK = 232448
SMEM_PER_SM = 233472
MAX_BLOCKS_PER_SM = 16  # 2048 threads / 128


@dataclass(frozen=True)
class Design:
    """What a launch of B1-B17 takes from its shapes:
    ``segments`` pieces per stream and ``chunk`` groups per block (B9,
    B11)."""

    segments: int
    chunk: int = 1

    def as_dict(self) -> dict:
        return {"k": self.segments, "t_tile": T_TILE, "Gc": self.chunk}


#: The shared memory a B9 block may take for its chunk of groups: seven
#: blocks an SM at config 5's tables (four groups a block; ``PERF.md`` §6).
B9_CHUNK_BUDGET = 32 * 1024
#: Segments fill this many rounds of every SM's resident blocks (shorter
#: blocks even out the SMs' ends), up to MAX_AUTO_SEGMENTS a stream.
SEGMENT_WAVES = 6
MAX_AUTO_SEGMENTS = 16


def segment_schedule(T: int, segments: int, overlap: int) -> List[Tuple[int, int, int]]:
    """``(scan start, first step of its own range, stop)`` of each segment
    of a ``T``-step stream (before each stream's own ``warm`` and ``vend``)."""
    out = []
    for i in range(segments):
        lo, hi = i * T // segments, (i + 1) * T // segments
        out.append((max(0, lo - overlap), lo, hi))
    return out


def run_segments(plain: Callable, streams, warm, vend, *tables, overlap: int,
                 segments: int):
    """int32 [S]: the count kernel's plain version ``plain(streams, warm,
    vend, *tables)`` run over each segment of :func:`segment_schedule` on its
    own (its steps sliced out, its warm and vend moved into the slice) and
    summed per stream: what the segmented kernels compute."""
    T = streams.shape[0]
    warm, vend = warm.long(), vend.long()
    total = torch.zeros(streams.shape[1], dtype=torch.int64, device=streams.device)
    for start, lo, hi in segment_schedule(T, segments, overlap):
        w = (torch.clamp(warm, min=lo) - start).to(torch.int32)
        v = (torch.clamp(vend, max=hi) - start).clamp(min=0).to(torch.int32)
        total += plain(streams[start:hi].contiguous(), w, v, *tables).long()
    return total.to(torch.int32)


def bitap_over_segments(plain: Callable, streams, tables, warm, trapmask=None, *,
                        overlap: int, segments: int):
    """B2's plain version ``plain(streams, *tables, warm, trapmask)`` run over
    each segment of :func:`segment_schedule` from its scan start (its warm
    moved into the slice, no vend): the counts summed per stream, int32
    ``[S]``, and with a ``trapmask`` the trap planes OR-ed, ``(counts,
    trap)``: what the segmented B2 computes."""
    T, S = streams.shape
    warm = warm.long()
    total = torch.zeros(S, dtype=torch.int64, device=streams.device)
    trap = torch.zeros(S, dtype=torch.int32, device=streams.device)
    for start, lo, hi in segment_schedule(T, segments, overlap):
        w = (torch.clamp(warm, min=lo) - start).to(torch.int32)
        out = plain(streams[start:hi].contiguous(), *tables, w, trapmask)
        if trapmask is None:
            total += out.long()
        else:
            total += out[0].long()
            trap |= out[1]
    total = total.to(torch.int32)
    return total if trapmask is None else (total, trap)


def or_over_segments(plain: Callable, streams, tables, trapmask=None, *, overlap: int,
                     segments: int):
    """A sticky plain version ``plain(streams, *tables, trapmask)`` run over
    each segment of :func:`segment_schedule`, from its scan start to its
    stop, its outputs OR-ed element by element, whatever their shape: B4's
    int32 ``[S]`` hits, and with a ``trapmask`` ``(hits, trap)``; B7's int32
    ``[V, S]`` planes, trap bits included.  What the segmented B4 and B7
    compute."""
    outs = None
    for start, _, hi in segment_schedule(streams.shape[0], segments, overlap):
        got = plain(streams[start:hi].contiguous(), *tables, trapmask)
        got = got if isinstance(got, tuple) else (got,)
        outs = got if outs is None else tuple(acc | x for acc, x in zip(outs, got))
    return outs if len(outs) > 1 else outs[0]


def _sticky_runs(run: Callable, streams, vend, overlap: int, segments: int):
    """A sticky scan ``run(streams, vend)`` on each segment's steps
    ``[max(0, p_i - overlap), min(p_{i+1}, vend))``, with the schedule."""
    sched = segment_schedule(streams.shape[0], segments, overlap)
    vend64 = vend.long()
    outs = []
    for start, _, hi in sched:
        v = (torch.clamp(vend64, max=hi) - start).clamp(min=0).to(torch.int32)
        outs.append(run(streams[start:hi].contiguous(), v))
    return outs, sched


def any_over_segments(plain: Callable, streams, vend, tables, *, overlap: int, segments: int):
    """int32 [S]: a sticky-any kernel's plain version ``plain(streams, vend,
    tables)`` (1 where the scan hit) run over each segment and OR-ed per
    stream: what the segmented B11 computes."""
    outs, _ = _sticky_runs(lambda x, v: plain(x, v, tables), streams, vend, overlap, segments)
    return (torch.stack(outs) != 0).any(0).to(torch.int32)


def combine_bases(bases, vend, schedule, root: int, absorb: int):
    """int32 [S]: B11's one-group answer from each segment's final base
    (``bases[i]`` [S], segment i of ``schedule`` scanned up to ``min(p_{i+1},
    vend)``): ``absorb`` where some segment reached it, else the base of the
    segment whose own range holds step ``vend - 1``, else ``root``."""
    vend = vend.long().clamp(max=schedule[-1][2])
    out = torch.full_like(vend, root)
    hit = torch.zeros_like(vend, dtype=torch.bool)
    for b, (_, lo, hi) in zip(bases, schedule):
        b = b.long()
        out = torch.where((vend > lo) & (vend <= hi), b, out)
        hit |= b == absorb
    return torch.where(hit, absorb, out).to(torch.int32)


def entry_over_segments(run: Callable, streams, vend, root: int, absorb: int, *,
                        overlap: int, segments: int):
    """int32 [S]: a sticky scan's final entry, ``run(streams, vend)`` (a
    plain version on one slice of steps) run over each segment, the entries
    combined by :func:`combine_bases` from ``root`` and ``absorb``: what the
    segmented B3 and B11's one-group mode compute."""
    outs, sched = _sticky_runs(run, streams, vend, overlap, segments)
    return combine_bases(outs, vend, sched, root, absorb)


def base_over_segments(plain: Callable, streams, vend, tables, *, overlap: int, segments: int):
    """int32 [S]: B11's one-group plain version ``plain(streams, vend,
    tables)`` run over each segment, the bases combined by
    :func:`combine_bases`: what the segmented kernel computes."""
    root, absorb = tables.gscal_host[0]
    return entry_over_segments(lambda x, v: plain(x, v, tables), streams, vend, root, absorb,
                               overlap=overlap, segments=segments)


def stitch_segments(plain: Callable, streams, *tables, overlap: int, segments: int):
    """int32 [T, S]: a states kernel's plain version ``plain(streams,
    *tables)`` run over each segment from its scan start, each keeping the
    rows of its own range ``[p_i, p_{i+1})``: what the segmented B12 and B17
    write."""
    T, S = streams.shape
    out = torch.empty(T, S, dtype=torch.int32, device=streams.device)
    for start, lo, hi in segment_schedule(T, segments, overlap):
        if hi > lo:
            out[lo:hi] = plain(streams[start:hi].contiguous(), *tables)[lo - start:]
    return out


def pair_segment_schedule(T: int, segments: int, restart: int) -> List[Tuple[int, int, int]]:
    """``(scan start, first step of its own range, stop)`` of each segment
    of the screen over ``T`` steps (T even): cut at the even steps ``p_i = 2
    * (i * (T // 2) // segments)``, scanned from ``max(0, p_i - restart)``
    (``restart`` even) so that no byte pair straddles a cut (an empty own
    range scans nothing); ``stage.cuh``'s ``pair_segment_steps``."""
    P = T // 2
    out = []
    for i in range(segments):
        lo, hi = 2 * (i * P // segments), 2 * ((i + 1) * P // segments)
        out.append((max(0, lo - restart) if lo < hi else lo, lo, hi))
    return out


def planes_over_segments(plain: Callable, streams, vend, tables, *, restart: int,
                         segments: int):
    """int32 ``[2, S]``: the screen's plain version ``plain(streams, vend,
    *tables)`` run over each segment of :func:`pair_segment_schedule` from
    its scan start to its stop (its vend moved into the slice), the two
    planes OR-ed per stream: what the segmented B14 computes."""
    S = streams.shape[1]
    out = torch.zeros(2, S, dtype=torch.int32, device=streams.device)
    vend = vend.long()
    for start, lo, hi in pair_segment_schedule(streams.shape[0], segments, restart):
        if hi > lo:
            v = (torch.clamp(vend, max=hi) - start).clamp(min=0).to(torch.int32)
            out |= plain(streams[start:hi].contiguous(), v, *tables)
    return out


def word_segment_schedule(T: int, segments: int, overlap: int) -> List[Tuple[int, int, int]]:
    """``(scan start, first step of its own range, stop)`` of each segment
    of a bitmap scan over ``T`` steps (``T % 32 == 0``): cut at the words
    ``p_i = 32 * (i * (T // 32) // segments)``, scanned from ``max(0, (p_i -
    overlap) & ~31)`` so that every 32-step tile is one word (an empty own
    range scans nothing); ``stage.cuh``'s ``word_segment_steps``."""
    W = T // 32
    out = []
    for i in range(segments):
        lo, hi = 32 * (i * W // segments), 32 * ((i + 1) * W // segments)
        out.append((max(0, (lo - overlap) & ~31) if lo < hi else lo, lo, hi))
    return out


def bits_over_segments(plain: Callable, streams, warm, vend, step: str, *tables, overlap: int,
                       segments: int):
    """``(counts int32 [S], bits int32 [T / 32, S])``: the bitmap kernel's
    plain version ``plain(streams, warm, vend, step, *tables)`` run over each
    segment of :func:`word_segment_schedule` from its scan start (its warm
    and vend moved into the slice), the counts summed per stream and each
    segment keeping the words of its own range: what the segmented B6 and B13
    compute."""
    T, S = streams.shape
    warm, vend = warm.long(), vend.long()
    counts = torch.zeros(S, dtype=torch.int64, device=streams.device)
    bits = torch.empty(T // 32, S, dtype=torch.int32, device=streams.device)
    for start, lo, hi in word_segment_schedule(T, segments, overlap):
        if hi == lo:
            continue
        w = (torch.clamp(warm, min=lo) - start).to(torch.int32)
        v = (torch.clamp(vend, max=hi) - start).clamp(min=0).to(torch.int32)
        c, b = plain(streams[start:hi].contiguous(), w, v, step, *tables)
        counts += c.long()
        bits[lo // 32:hi // 32] = b[(lo - start) // 32:]
    return counts.to(torch.int32), bits


def group_chunks(G: int, chunk: int) -> List[Tuple[int, int]]:
    """The ``[g0, g1)`` group ranges of B9's blocks."""
    return [(g0, min(G, g0 + chunk)) for g0 in range(0, G, chunk)]


def comb_smem_bytes(comb_words: int, def_words: int) -> int:
    """B15's dynamic shared memory (``seg_smem_bytes``)."""
    words = (REP_WORDS + comb_words + def_words + 3) & ~3
    return 4 * words + 2 * T_TILE * BLOCK_STREAMS


def chunk_smem_bytes(chunk: int, comb_words: int, aux_words: int) -> int:
    """B9's dynamic shared memory for a chunk of groups (``chunk_smem_bytes``):
    the class words, the count ranges and each group's widened comb, aux and
    root entries (``group_words``), then two tiles."""
    cls = REP_WORDS if chunk == 1 else 256 * ((chunk + 3) // 4)
    group = 2 * comb_words + 2 * aux_words + 128
    words = (cls + chunk * (RANGE_SLOTS + group) + 3) & ~3
    return 4 * words + 2 * T_TILE * BLOCK_STREAMS


#: kMaxWordFields of ``csrc/matchbits.cu``: the bitap step's count fields.
MAX_WORD_FIELDS = 30


def dense_bits_smem_bytes(table_words: int) -> int:
    """B1 and B3 (``dense_count.cu``) and B6's dense step (``matchbits.cu``):
    the replicated class map and the packed table, then two tiles."""
    return 4 * ((REP_WORDS + table_words + 3) & ~3) + 2 * T_TILE * BLOCK_STREAMS


def bitap_bits_smem_bytes() -> int:
    """B6's bitap step: the 256-word mask table and the count fields, then
    two tiles."""
    return 4 * ((256 + 2 * MAX_WORD_FIELDS + 3) & ~3) + 2 * T_TILE * BLOCK_STREAMS


def filter_smem_bytes(words: int) -> int:
    """B14: ``words`` tables of 128 entries, then two tiles."""
    return 4 * 128 * words + 2 * T_TILE * BLOCK_STREAMS


def bitap_smem_bytes(words: int, fields: int) -> int:
    """B2, B4 and B7 (``bitap_count.cu``): ``words`` mask tables of 256 words
    and the count fields' end bits and weights (B4 and B7 have none), then
    two tiles."""
    return 4 * ((256 * words + 2 * fields + 3) & ~3) + 2 * T_TILE * BLOCK_STREAMS


def pick_chunk(G: int, comb_words: int, aux_words: int) -> int:
    """Groups per B9 block: as many as fit ``B9_CHUNK_BUDGET`` bytes of
    shared memory (at least one, at most ``MAX_CHUNK``), balanced over the
    chunks.  Raises ``ValueError`` when one group does not fit a block."""
    if chunk_smem_bytes(1, comb_words, aux_words) > SMEM_PER_BLOCK:
        raise ValueError("one group's tables exceed a block's shared memory")
    fit = 1
    while (fit < min(G, MAX_CHUNK)
           and chunk_smem_bytes(fit + 1, comb_words, aux_words) <= B9_CHUNK_BUDGET):
        fit += 1
    n_chunks = -(-G // fit)
    return -(-G // n_chunks)


def pick_segments(S: int, T: int, overlap: Optional[int], smem: int, n_sm: int,
                  n_chunks: int = 1) -> int:
    """Segments per stream: enough blocks for ``SEGMENT_WAVES`` rounds of
    every SM's resident slots (as many blocks as its shared memory holds), at
    most ``MAX_AUTO_SEGMENTS``; one segment without an overlap, and never a
    segment no longer than the overlap."""
    if overlap is None or T <= 0:
        return 1
    per_sm = max(1, min(MAX_BLOCKS_PER_SM, SMEM_PER_SM // (smem + 1024)))
    blocks = -(-S // BLOCK_STREAMS) * n_chunks
    k = max(1, min(MAX_AUTO_SEGMENTS, -(-SEGMENT_WAVES * n_sm * per_sm // blocks)))
    while k > 1 and T // k <= overlap:
        k -= 1
    return k


_SMS: dict = {}


def sm_count(device) -> int:
    """The SM count of a CUDA ``device``."""
    idx = torch.device(device).index
    idx = torch.cuda.current_device() if idx is None else idx
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def comb_design(S: int, T: int, overlap: Optional[int], comb_words: int, def_words: int,
                n_sm: int) -> Design:
    """B15's and B17's launch for ``S`` streams of ``T`` steps on ``n_sm``
    SMs."""
    return Design(pick_segments(S, T, overlap, comb_smem_bytes(comb_words, def_words), n_sm))


def grouped_design(S: int, T: int, overlap: Optional[int], G: int, comb_words: int,
                   aux_words: int, n_sm: int) -> Design:
    """B9's and B11's launch for ``S`` streams of ``T`` steps and ``G``
    groups (count or sticky tables); B8's and B12's with ``G = 1``."""
    chunk = pick_chunk(G, comb_words, aux_words)
    smem = chunk_smem_bytes(chunk, comb_words, aux_words)
    return Design(pick_segments(S, T, overlap, smem, n_sm, n_chunks=-(-G // chunk)), chunk)


def bits_design(S: int, T: int, overlap: Optional[int], smem: int, n_sm: int) -> Design:
    """B6's and B13's launch for ``S`` streams of ``T`` steps on ``n_sm`` SMs
    with ``smem`` bytes of shared memory a block: ``pick_segments``, at most
    one segment a word."""
    return Design(max(1, min(pick_segments(S, T, overlap, smem, n_sm), T // 32)))


__all__ = [
    "Design",
    "T_TILE",
    "any_over_segments",
    "base_over_segments",
    "bitap_bits_smem_bytes",
    "bitap_over_segments",
    "bitap_smem_bytes",
    "bits_design",
    "bits_over_segments",
    "chunk_smem_bytes",
    "combine_bases",
    "comb_design",
    "comb_smem_bytes",
    "dense_bits_smem_bytes",
    "entry_over_segments",
    "filter_smem_bytes",
    "group_chunks",
    "grouped_design",
    "or_over_segments",
    "pair_segment_schedule",
    "pick_chunk",
    "pick_segments",
    "planes_over_segments",
    "run_segments",
    "segment_schedule",
    "sm_count",
    "stitch_segments",
    "word_segment_schedule",
]
