"""Stream layout: a corpus cut into overlap-warmed streams, staged on a device;
and the reference scan engine, ``XlaAcEngine``.

Counterpart of ``alfred_margaret_tpu/ops/xla_scan.py`` (``StreamPlan``,
``_round_up``, ``plan_streams``, ``_stream_validity``, ``build_streams``,
``stage_streams_device``, ``XlaAcEngine``, ``expand_hits``,
``extract_matches``).  That module imports ``jax`` at the top, so the numpy
helpers are copied here (``tests/test_torch_layout.py`` pins each copy to its
original), and the device staging and the engine's ``lax.scan`` loops are
redone in torch.

Layout: one haystack is split into S streams of L emission bytes, each
preceded by K = max_needle_bytes - 1 warm-up bytes replayed from the previous
stream.  Streams are time-major ``[T, S]`` uint8 and stream ``s`` emits
matches ending at t in ``[warm[s], vend[s])``.  The warm-up replay is exact
because an Aho-Corasick state depends on the last max_needle_bytes bytes
only.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..utils import trace, utf8
from ..utils.device import resolve_device


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(x: int, m: int) -> int:
    return _ceil_div(x, m) * m


@dataclass(frozen=True)
class StreamPlan:
    """How a flat byte array is laid out into overlap-warmed streams."""

    n: int  # total input bytes
    n_streams: int  # S
    emit_len: int  # L: emission bytes per stream (last stream may emit less)
    overlap: int  # K: warm-up bytes (max_needle_bytes - 1)
    time_len: int  # T >= K + L, padded stream length


def plan_streams(
    n: int,
    overlap: int,
    n_streams: Optional[int] = None,
    max_streams: int = 1024,
    min_emit: int = 512,
) -> StreamPlan:
    """The reference scan engine's stream decomposition of an ``n``-byte
    input: as many streams as ``max_streams`` allows while each emits at
    least ``min_emit`` bytes and the warm-up stays under ~12.5% of the
    emission (the kernel engines plan their own, ``DenseAcEngine._plan``)."""
    if n <= 0:
        return StreamPlan(n=n, n_streams=1, emit_len=1, overlap=overlap, time_len=1 + overlap)
    if n_streams is None:
        by_overlap = n // max(1, 8 * overlap) if overlap > 0 else max_streams
        n_streams = int(min(max_streams, max(1, min(n // min_emit, by_overlap))))
        if n_streams >= 8:
            n_streams = max(8, (n_streams // 8) * 8)
    n_streams = max(1, min(n_streams, n))
    emit_len = _ceil_div(n, n_streams)
    return StreamPlan(
        n=n,
        n_streams=n_streams,
        emit_len=emit_len,
        overlap=overlap,
        time_len=emit_len + overlap,
    )


def _stream_validity(n: int, S: int, L: int, K: int):
    """Per-stream (warm_start, valid_end) int32 arrays.

    Emission is valid for t in [warm_start, valid_end).  Fully padded
    streams (emit_begin >= n) get warm = vend = 0: their windows are
    right-padding zeros, which must never be scanned live (needles may
    contain NUL bytes), and their counts are left out of every reduction."""
    idx = np.arange(S, dtype=np.int64)
    emit_begin = idx * L
    emit_end = np.minimum(emit_begin + L, n)
    warm_start = np.minimum(K, emit_begin)
    valid_end = warm_start + np.maximum(0, emit_end - emit_begin)
    empty = emit_begin >= n
    warm_start[empty] = 0
    valid_end[empty] = 0
    return warm_start.astype(np.int32), valid_end.astype(np.int32)


def _n_fix(S: int, L: int, K: int) -> int:
    """Head streams whose window would start in the left padding; they read
    from data[0] instead (the reference layout: start = max(0, i*L - K))."""
    return 1 if L >= K else min(S, _ceil_div(K, L))


def build_streams(data: np.ndarray, plan: StreamPlan) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Lay out ``data`` into time-major streams on the host.

    Returns ``(streams_ts, warm_start, valid_end)``: ``streams_ts`` is uint8
    [T, S] and stream s emits for t in [warm_start[s], valid_end[s])."""
    n, S, L, K, T = plan.n, plan.n_streams, plan.emit_len, plan.overlap, plan.time_len
    data = np.ascontiguousarray(data, dtype=np.uint8)
    # Stream i reads pad[i*L : i*L + T] = data[i*L - K : i*L - K + T].
    pad = np.zeros(K + max((S - 1) * L + T, n), dtype=np.uint8)
    pad[K : K + n] = data
    windows = np.lib.stride_tricks.sliding_window_view(pad, T)[:: max(1, L)][:S]
    streams = windows.T.copy()  # [T, S]
    for i in range(_n_fix(S, L, K)):
        streams[:, i] = pad[K : K + T]
    warm_start, valid_end = _stream_validity(n, S, L, K)
    # Zero every window's tail past its valid end: the tail holds bytes of
    # later streams (T is padded, head streams are shifted), and pads must
    # be inert for every stream.
    streams[np.arange(T, dtype=np.int32)[:, None] >= valid_end[None, :]] = 0
    return streams, warm_start, valid_end


#: Bytes of one half of a device's staging ring: the text crosses to the
#: device in slices of this size, through 2 x 16 MiB of host memory a device.
RING_SLICE_BYTES = 16 << 20

#: A slice of at least this many bytes is copied into the ring by ATen's
#: parallel copy, on the host's intra-op threads; a shorter one by
#: ``np.copyto`` on the calling thread, which wakes no thread.  The two cross
#: between 192 and 256 KiB on an H100's host (8 cores, 8 intra-op threads,
#: a read-only 1 GiB source into the pinned ring, medians): ``np.copyto``
#: 7.8 and 6.8 GB/s, ``copy_`` 6.2 and 7.8; at 16 MiB 4.9 against 31.3.
PARALLEL_COPY_BYTES = 256 << 10


class _ReadOnlyBytes:
    """The array interface of a host array, its memory marked writable:
    ``torch.from_numpy`` then views a read-only source (``bytes``, a
    read-only memmap) without copying it and without a warning.  The view
    is only ever read: it is the source of the ring's copies."""

    def __init__(self, a: np.ndarray):
        self.a = a  # the memory lives as long as the view
        iface = a.__array_interface__
        self.__array_interface__ = dict(iface, data=(iface["data"][0], False))


def _host_view(src: np.ndarray) -> Optional[torch.Tensor]:
    """A CPU tensor over the 1-D uint8 array ``src``'s memory, no copy;
    None for a layout torch cannot view (a negative stride)."""
    if src.strides[0] < 0:
        return None
    return torch.from_numpy(np.asarray(_ReadOnlyBytes(src)))


class _StagingRing:
    """A device's host staging buffer: two halves of ``slice_bytes``, pinned
    for a CUDA device, allocated at the device's first staging and kept for
    the life of the process.

    ``send`` walks a host array in slices: each is copied into a free half,
    and that half's copy to the device is enqueued without waiting, so the
    host's copy of slice i + 1 runs while slice i crosses to the device.
    Before a half is written again the host waits on the event recorded
    after its last copy, so a copy in flight is never overwritten.  The lock
    keeps two engines on one device off each other's halves."""

    def __init__(self, device: torch.device, slice_bytes: int):
        self.cuda = device.type == "cuda"
        self.slice_bytes = slice_bytes
        self.buf = torch.empty(2 * slice_bytes, dtype=torch.uint8, pin_memory=self.cuda)
        self.host = self.buf.numpy()
        self.sent: list = [None, None]  # per half: the event after its last copy
        self.half = 0
        self.lock = threading.Lock()

    def send(self, src: np.ndarray, dst: torch.Tensor) -> None:
        """Copy the 1-D uint8 host array ``src`` into the uint8 tensor
        ``dst`` of the same length.  ``src`` is only read, and may be
        strided.  A slice of ``PARALLEL_COPY_BYTES`` or more is copied by
        ``Tensor.copy_`` on the intra-op threads, with the GIL released.
        Spans: ``amt.stage.host`` around each slice's host copy, with
        ``amt.stage.host.split`` inside it where the copy is parallel;
        ``amt.stage.htod`` around each enqueue and each wait."""
        step = self.slice_bytes
        view = _host_view(src) if len(src) >= PARALLEL_COPY_BYTES else None
        with self.lock:
            for off in range(0, len(src), step):
                m = min(step, len(src) - off)
                h, self.half = self.half, 1 - self.half
                lo = h * step
                if self.sent[h] is not None:
                    with trace.span("amt.stage.htod"):
                        self.sent[h].synchronize()
                    self.sent[h] = None
                with trace.span("amt.stage.host"):
                    if view is not None and m >= PARALLEL_COPY_BYTES:
                        with trace.span("amt.stage.host.split"):
                            self.buf[lo : lo + m].copy_(view[off : off + m])
                    else:
                        np.copyto(self.host[lo : lo + m], src[off : off + m])
                with trace.span("amt.stage.htod"):
                    dst[off : off + m].copy_(self.buf[lo : lo + m], non_blocking=self.cuda)
                    if self.cuda:
                        self.sent[h] = torch.cuda.Event()
                        self.sent[h].record(torch.cuda.current_stream(dst.device))


_RINGS: Dict[torch.device, _StagingRing] = {}
_RINGS_LOCK = threading.Lock()


def _ring(device: torch.device) -> _StagingRing:
    """The staging ring of ``device``, made at its first staging."""
    with _RINGS_LOCK:
        ring = _RINGS.get(device)
        if ring is None:
            ring = _RINGS[device] = _StagingRing(device, RING_SLICE_BYTES)
        return ring


def stage_streams_device(data, plan: StreamPlan, device: torch.device):
    """Upload the corpus once and window it on ``device``.

    Returns ``(streams [T, S] uint8 tensor on device, warm_start, valid_end)``
    with the host int32 arrays of ``_stream_validity``; byte for byte the
    same streams as ``build_streams``.  The host does no windowing: the n
    corpus bytes go through the device's staging ring (``_StagingRing``:
    a fixed 2 x ``RING_SLICE_BYTES`` of host memory, pinned on CUDA) straight
    into the padded buffer on the device, which builds the [T, S] layout with
    one strided view and one transpose copy.  ``data`` (an ndarray, a memmap,
    ``bytes`` or a memoryview) is only read.
    """
    n, S, L, K, T = plan.n, plan.n_streams, plan.emit_len, plan.overlap, plan.time_len
    with trace.span("amt.stage"):
        if not isinstance(data, np.ndarray):
            data = np.frombuffer(data, dtype=np.uint8)
        if data.dtype != np.uint8 or data.ndim != 1:
            with trace.span("amt.stage.host"):
                data = np.ascontiguousarray(data, dtype=np.uint8).reshape(-1)
        # The head streams read pad[K : K + T]: rows * L >= K + T, also for
        # a corpus shorter than the overlap.
        rows = max(S + _ceil_div(T, L), _ceil_div(K + max(n, T), L)) + 1
        pad = torch.zeros(rows * L, dtype=torch.uint8, device=device)
        _ring(pad.device).send(data, pad[K : K + n])
        with trace.span("amt.stage.layout"):
            # Window s is pad[s*L : s*L + T]; rows * L >= (S - 1) * L + T.
            # clone, not contiguous(): with S = 1 the transpose is already
            # contiguous and contiguous() would return a view of pad.
            streams = pad.unfold(0, T, L)[:S].T.clone(memory_format=torch.contiguous_format)
            n_fix = _n_fix(S, L, K)
            streams[:, :n_fix] = pad[K : K + T].unsqueeze(1)
            warm_start, valid_end = _stream_validity(n, S, L, K)
            vend = torch.from_numpy(valid_end).to(device)
            t_idx = torch.arange(T, dtype=torch.int32, device=device).unsqueeze(1)
            streams.masked_fill_(t_idx >= vend.unsqueeze(0), 0)
    return streams, warm_start, valid_end


def emission_index(plan: StreamPlan, warm: torch.Tensor) -> torch.Tensor:
    """int64 [n] on ``warm``'s device: the flat ``[T, S]`` index of the step
    that emits each corpus position (stream ``i // L``, step ``warm + i %
    L``), the stitch of the JAX engines' ``final_states``."""
    i = torch.arange(plan.n, dtype=torch.int64, device=warm.device)
    s = i // plan.emit_len
    t = warm.long()[s] + (i - s * plan.emit_len)
    return t * plan.n_streams + s


class XlaAcEngine:
    """The reference scan engine: the full byte DFA over ``plan_streams``'s
    streams on ``device``, one gather of ``delta[state * 256 + byte]`` per
    time step for all streams at once.

    The port of the JAX engine (``xla_scan.py:269``), whose scans are
    ``lax.scan`` loops outside any Pallas kernel (``_scan_count``,
    ``_scan_states``, ``_scan_state_hits``): here a Python loop launches a
    few torch ops per step, so its wall grows with the stream length.  It
    holds any machine, whatever its size, and serves the sets that no kernel
    table and no needle grouping holds (a large set with an empty needle).
    ``bucket`` rounds the emission length up to a multiple of 512, as the
    JAX engine does to bound its compiled shapes, so both scan the same
    streams."""

    def __init__(self, machine, max_streams: int = 1024, bucket: bool = True, *, device="cuda"):
        self.machine = machine
        self.device = resolve_device(device)
        self.delta = torch.from_numpy(
            np.ascontiguousarray(machine.delta, dtype=np.int64).reshape(-1)).to(self.device)
        self.match_count = torch.from_numpy(
            np.asarray(machine.match_count, dtype=np.int64)).to(self.device)
        self.n_states = int(machine.delta.shape[0])
        self.overlap = max(0, machine.max_needle_bytes - 1)
        self.max_streams = max_streams
        self.bucket = bucket

    def _streams(self, data: np.ndarray):
        """(plan, streams [T, S] as int64 on the device, the [T, S] emission
        mask)."""
        plan = plan_streams(len(data), self.overlap, None, self.max_streams)
        if self.bucket:
            emit = max(1, _round_up(plan.emit_len, 512))
            plan = StreamPlan(n=plan.n, n_streams=plan.n_streams, emit_len=emit,
                              overlap=plan.overlap, time_len=emit + plan.overlap)
        streams, warm, vend = stage_streams_device(data, plan, self.device)
        t = torch.arange(plan.time_len, device=self.device).unsqueeze(1)
        warm = torch.from_numpy(warm).to(self.device)
        valid = (t >= warm) & (t < torch.from_numpy(vend).to(self.device))
        return plan, streams.long(), valid, warm

    def _scan(self, streams: torch.Tensor):
        """Yield the [S] states after each time step, from the root."""
        states = torch.zeros(streams.shape[1], dtype=torch.int64, device=self.device)
        for row in streams:
            states = self.delta[states * 256 + row]
            yield states

    def count(self, text: utf8.TextLike) -> int:
        data = utf8.to_u8(text)
        if len(data) == 0:
            return 0
        _, streams, valid, _ = self._streams(data)
        counts = torch.zeros(streams.shape[1], dtype=torch.int64, device=self.device)
        for states, v in zip(self._scan(streams), valid):
            counts += torch.where(v, self.match_count[states], 0)
        return int(counts.sum())

    def final_states(self, text: utf8.TextLike) -> np.ndarray:
        """int32 [n]: the DFA state after each byte of ``text``."""
        data = utf8.to_u8(text)
        if len(data) == 0:
            return np.zeros(0, dtype=np.int32)
        plan, streams, _, warm = self._streams(data)
        states_ts = torch.stack(list(self._scan(streams)))
        return states_ts.reshape(-1)[emission_index(plan, warm)].to(torch.int32).cpu().numpy()

    def state_hits(self, text: utf8.TextLike) -> np.ndarray:
        """bool [n_states]: which states were entered at emission positions
        (the root never counts)."""
        hits = torch.zeros(self.n_states, dtype=torch.bool, device=self.device)
        data = utf8.to_u8(text)
        if len(data) > 0:
            _, streams, valid, _ = self._streams(data)
            for states, v in zip(self._scan(streams), valid):
                hits[torch.where(v, states, 0)] = True
            hits[0] = False
        return hits.cpu().numpy()


def expand_hits(machine, ends: np.ndarray, hit_states: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Expand hit (end-position, state) pairs into (ends, value_ids) with
    CSR (emission) order within a position, the scalar fold's ordering.
    The JAX package keeps two copies of this expansion
    (``xla_scan.expand_hits`` and ``pallas_scan._expand_outputs``); the port
    keeps this one."""
    if len(ends) == 0:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int32)
    hit_counts = machine.match_count[hit_states]
    positions = np.repeat(np.asarray(ends, dtype=np.int64), hit_counts)
    offs = machine.out_offset[hit_states]
    total = int(hit_counts.sum())
    base = np.repeat(offs, hit_counts)
    ramp = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(hit_counts) - hit_counts, hit_counts
    )
    value_ids = machine.out_values[base + ramp]
    return positions, value_ids


def extract_matches(machine, states: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Expand per-position states into (positions one past the end,
    value_ids): positions ascend, and the values of one position keep CSR
    (emission) order, the scalar fold's ordering."""
    counts = machine.match_count[states]
    hit_pos = np.flatnonzero(counts)
    if len(hit_pos) == 0:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int32)
    return expand_hits(machine, hit_pos + 1, states[hit_pos])


__all__ = [
    "StreamPlan",
    "XlaAcEngine",
    "build_streams",
    "emission_index",
    "expand_hits",
    "extract_matches",
    "plan_streams",
    "stage_streams_device",
]
