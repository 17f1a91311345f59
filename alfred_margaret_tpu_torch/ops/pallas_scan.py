"""Dense DFA engine over the hand-written CUDA kernels B1, B3 and B6.

Counterpart of ``alfred_margaret_tpu/ops/pallas_scan.py``:
``CapacityError``, ``_zero_inert``, ``CompressedMachine.from_machine``,
``_StickyView``, ``StagedStreams``, ``expand_hit_bits`` and
``states_at_positions`` are copied as numpy (that module imports ``jax``;
``tests/test_torch_layout.py`` pins the copies to the originals), and
``DenseAcEngine`` takes the place of ``PallasAcEngine`` for ``stage``,
``adopt_staged``, counting (B1), containsAny over the sticky view (B3, with
the early-exit segments) and match extraction through the hit bitmap (B6).
The TPU-only parts are left out: the ``reps`` re-scan grid, the
``defer``/``nomask``/``fold``/``wpairs`` variants, which shave vector
operations on the TPU, and the two-level compaction with its capacity
retries, which saved relay round trips.  The packed-states kernel (B5) is
not ported yet: ROADMAP item 10.

The automaton is compressed to k byte classes and packed into
``packed[state * k + cls] = count << state_bits | next_state * k`` so that a
step is one class lookup and one table lookup (``kernels/dense_count.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..kernels.dense_contains import dense_contains
from ..kernels.dense_count import dense_count, dense_count_plain
from ..kernels.matchbits import matchbits
from ..models.ac import AcMachine
from ..native.cpp_engine import _default_threads
from ..utils import utf8
from ..utils.device import resolve_device
from .xla_scan import StreamPlan, expand_hits, stage_streams_device

#: Maximum packed-table rows of 128 int32 entries (24 KiB: the B1 kernel keeps
#: the table in shared memory).  The value is the JAX package's, so both
#: packages accept the same machines.
MAX_ROWS = 48

#: Packed-entry layouts.  packing=1: one int32 entry per word, low 20 bits
#: next_state * k, high bits the match count.  packing=2: two 16-bit entries
#: per word (low 13 bits next_state * k, top 3 bits the count).
_STATE_BITS = 20
_STATE_BITS16 = 13


class CapacityError(ValueError):
    """Automaton too large for the dense kernel's table budget."""


def _zero_inert(machine) -> bool:
    """True when scanning right-padding zeros is a no-op for the machine:
    byte 0 drives every state to the root and the root emits nothing.  It
    fails when a needle holds NUL (or is empty); the kernels then rely on
    the per-stream [warm, vend) window alone."""
    return bool((machine.delta[:, 0] == 0).all()) and int(machine.match_count[0]) == 0


@dataclass
class CompressedMachine:
    """Byte-class-compressed, packed automaton arrays (host side)."""

    classmap: np.ndarray  # int32 [256] byte -> class
    packed: np.ndarray  # int32 [rows * 128] flat entries (see packing)
    n_states: int
    k: int  # number of byte classes
    rows: int  # 128-entry rows of `packed`
    packing: int = 1  # entries per int32 word (1 or 2)

    @property
    def state_bits(self) -> int:
        return _STATE_BITS16 if self.packing == 2 else _STATE_BITS

    @property
    def state_mask(self) -> int:
        return (1 << self.state_bits) - 1

    @staticmethod
    def from_machine(
        machine: AcMachine, max_rows: int = MAX_ROWS, force_packing: Optional[int] = None
    ) -> "CompressedMachine":
        delta = machine.delta  # [S, 256]
        n_states = delta.shape[0]
        # Byte-class compression: unique delta columns become classes.
        cols = np.ascontiguousarray(delta.T)  # [256, S]
        uniq, inv = np.unique(cols, axis=0, return_inverse=True)
        k = uniq.shape[0]
        n_entries = n_states * k
        max_count = int(machine.match_count.max(initial=0))
        comp = uniq.T.astype(np.int64)  # [n_states, k] next-state per class

        # 16-bit packing when it reduces rows and the fields fit.
        if (
            force_packing != 1
            and n_entries > 128
            and n_entries < (1 << _STATE_BITS16)
            and max_count <= 7
        ):
            if n_entries > max_rows * 256:
                raise CapacityError(
                    f"n_states*k = {n_entries} exceeds {max_rows*256} "
                    "16-bit packed entries"
                )
            e = (machine.match_count.astype(np.int64)[comp] << _STATE_BITS16) | (
                comp * k
            )
            flat = e.reshape(-1)
            n_pairs = -(-len(flat) // 2)
            pairs = np.zeros(n_pairs * 2, dtype=np.int64)
            pairs[: len(flat)] = flat
            out = pairs[0::2] | (pairs[1::2] << 16)
            rows = -(-len(out) // 128)
            padded = np.zeros(rows * 128, dtype=np.int64)
            padded[: len(out)] = out
            return CompressedMachine(
                classmap=inv.astype(np.int32),
                packed=padded.astype(np.int32),
                n_states=n_states,
                k=k,
                rows=rows,
                packing=2,
            )

        if n_entries > max_rows * 128:
            raise CapacityError(
                f"n_states*k = {n_states}*{k} = {n_entries} exceeds "
                f"{max_rows*128} packed entries"
            )
        # 31, not 32: keep the count out of the int32 sign bit.
        if max_count >= (1 << (31 - _STATE_BITS)):
            raise CapacityError("per-state match count exceeds packed field")
        if n_entries >= (1 << _STATE_BITS):
            raise CapacityError("state*k exceeds packed state field")
        packed = (machine.match_count.astype(np.int64)[comp] << _STATE_BITS) | (
            comp * k
        )
        flat = packed.reshape(-1)
        rows = -(-len(flat) // 128)
        out = np.zeros(rows * 128, dtype=np.int64)
        out[: len(flat)] = flat
        return CompressedMachine(
            classmap=inv.astype(np.int32),
            packed=out.astype(np.int32),
            n_states=n_states,
            k=k,
            rows=rows,
            packing=1,
        )


@dataclass
class DenseTables:
    """The B1 kernel's tables on one device (``convert.dense_tables_from_jax``
    builds the same from the JAX engine's arrays)."""

    classmap: torch.Tensor  # int32 [256]
    table: torch.Tensor  # int32 [rows * 128]
    packing: int
    state_bits: int

    @staticmethod
    def from_compressed(comp: CompressedMachine, device) -> "DenseTables":
        cm = np.zeros(256, dtype=np.int32)
        cm[: len(comp.classmap)] = comp.classmap
        return DenseTables(
            classmap=torch.from_numpy(cm).to(device),
            table=torch.from_numpy(np.ascontiguousarray(comp.packed, dtype=np.int32)).to(device),
            packing=comp.packing,
            state_bits=comp.state_bits,
        )


class _StickyView:
    """Absorbing-state view of an ``AcMachine`` for existence queries.

    Entering any match state (``match_count > 0``) leads instead to a new
    absorbing state that loops to itself, and all counts are dropped: the
    final state says whether any match was seen (the reference's
    ``containsAny`` fold, ``AhoCorasick/Searcher.hs:156-164``)."""

    def __init__(self, machine: AcMachine):
        delta = machine.delta
        n = delta.shape[0]
        self.absorb = n
        d2 = np.empty((n + 1, 256), dtype=np.int32)
        d2[:n] = np.where(machine.match_count[delta] > 0, n, delta)
        d2[n] = n
        self.delta = d2
        self.match_count = np.zeros(n + 1, dtype=np.int32)
        # Failure links (the absorbing state nominally fails to the root).
        self.fail = (
            np.concatenate([machine.fail, np.zeros(1, machine.fail.dtype)])
            if machine.fail is not None
            else None
        )


@dataclass
class StickyTables(DenseTables):
    """The B3 kernel's tables: the sticky view's packed tables and
    ``absorb``, the final entry of a stream that saw a match (the absorbing
    state times k).  ``convert.sticky_tables_from_jax`` builds the same from
    the JAX engine's arrays."""

    absorb: int

    @staticmethod
    def from_machine(machine: AcMachine, device) -> "StickyTables":
        """Raises ``CapacityError`` when the view, which has one state more
        than the machine, exceeds ``MAX_ROWS``."""
        sv = _StickyView(machine)
        comp = CompressedMachine.from_machine(sv)
        t = DenseTables.from_compressed(comp, device)
        return StickyTables(t.classmap, t.table, t.packing, t.state_bits, sv.absorb * comp.k)


@dataclass
class StagedStreams:
    """Device-resident stream layout, reusable across scans and engines."""

    plan: StreamPlan
    streams: torch.Tensor  # [T, S] uint8 on the device
    warm: torch.Tensor  # int32 [S] on the device
    vend: torch.Tensor  # int32 [S] on the device
    #: bool [S]: streams with any emission.  Counts are summed over these
    #: only (fully padded streams have warm = vend = 0).
    live_np: np.ndarray
    warm_np: np.ndarray  # int32 [S], host copy of ``warm``
    vend_np: np.ndarray  # int32 [S], host copy of ``vend``
    #: Host reference to the raw corpus bytes: match extraction replays the
    #: bytes before each hit from it to recover the hit's state (None: no
    #: host corpus, and extraction needs B5).
    data_np: Optional[np.ndarray]


class DenseAcEngine:
    """Counts all matches of ``machine`` with the dense DFA kernel on ``device``.

    ``n_streams`` streams (S) of ``ceil(n / S)`` emission bytes each, time
    padded to a ``t_tile`` multiple: the same stream plan as
    ``PallasAcEngine`` with the same arguments, so per-stream counts compare
    one to one.  Raises ``CapacityError`` when the packed table exceeds
    ``MAX_ROWS`` rows.
    """

    #: The packed-states kernel that extraction without the host corpus needs.
    STATES_KERNEL = "B5"

    def __init__(self, machine: AcMachine, *, device="cuda", n_streams: int = 32768, t_tile: int = 128):
        self._init_streams(machine, device, n_streams, t_tile)
        self.comp = CompressedMachine.from_machine(machine)
        self.tables = DenseTables.from_compressed(self.comp, self.device)
        self._sticky: Optional[StickyTables] = None

    def _init_streams(self, machine: AcMachine, device, n_streams: int, t_tile: int) -> None:
        """The machine, device and stream layout, shared by every engine."""
        if n_streams < 1 or t_tile < 1:
            raise ValueError("n_streams and t_tile must be positive")
        self.machine = machine
        self.device = resolve_device(device)
        self.S = n_streams
        self.t_tile = t_tile
        self.overlap = max(0, machine.max_needle_bytes - 1)

    def _plan(self, n: int) -> StreamPlan:
        emit = max(1, -(-n // self.S))
        T = -(-(emit + self.overlap) // self.t_tile) * self.t_tile
        return StreamPlan(
            n=n, n_streams=self.S, emit_len=emit, overlap=self.overlap, time_len=T
        )

    def stage(self, data: np.ndarray) -> StagedStreams:
        """Stage a corpus on the device once, for any number of scans."""
        data = utf8.to_u8(data)
        plan = self._plan(len(data))
        streams, warm, vend = stage_streams_device(data, plan, self.device)
        return StagedStreams(
            plan=plan,
            streams=streams,
            warm=torch.from_numpy(warm).to(self.device),
            vend=torch.from_numpy(vend).to(self.device),
            live_np=vend > 0,
            warm_np=warm,
            vend_np=vend,
            data_np=data,
        )

    def adopt_staged(self, st: Optional[StagedStreams]) -> Optional[StagedStreams]:
        """``st`` when this engine can scan a staging made by another engine
        (possibly for another machine), else None (the caller restages).
        The layout does not depend on the machine; it needs the same device
        and stream count, a ``t_tile``-aligned length and a warm-up overlap
        that covers this machine's needles."""
        if st is None or st.plan.n_streams != self.S or st.streams.device != self.device:
            return None
        if st.plan.time_len % self.t_tile:
            return None
        if st.plan.overlap < max(0, self.machine.max_needle_bytes - 1):
            return None
        return st

    def _kernel_args(self, st: StagedStreams) -> tuple:
        t = self.tables
        return (st.streams, t.classmap, t.table, st.warm, st.vend, t.packing, t.state_bits)

    def stream_counts(self, st: StagedStreams) -> torch.Tensor:
        """int32 [S] per-stream counts on the device (kernel B1)."""
        return dense_count(*self._kernel_args(st))

    def stream_counts_plain(self, st: StagedStreams) -> torch.Tensor:
        """``stream_counts`` by the kernel's plain torch version, on any
        device (checks the kernel on the card)."""
        return dense_count_plain(*self._kernel_args(st))

    def count_staged(self, st: StagedStreams) -> int:
        """Total count: per-stream int32 counts summed in int64 over live
        streams on the host."""
        counts = self.stream_counts(st).cpu().numpy().astype(np.int64)
        return int(counts[st.live_np].sum())

    def count(self, text: utf8.TextLike) -> int:
        data = utf8.to_u8(text)
        if len(data) == 0:
            return 0
        return self.count_staged(self.stage(data))

    # -- containsAny: the sticky scan (kernel B3) ------------------------------

    #: Segment size of the early-exit containsAny scan (the JAX package's).
    CONTAINS_SEG_BYTES = 32 << 20

    def sticky_tables(self) -> StickyTables:
        """The sticky view's tables on this engine's device, built at first
        use; raises ``CapacityError`` when they exceed ``MAX_ROWS``."""
        if self._sticky is None:
            self._sticky = StickyTables.from_machine(self.machine, self.device)
        return self._sticky

    def sticky_args(self, st: StagedStreams, s0: int = 0, s1: Optional[int] = None) -> tuple:
        """Arguments of ``dense_contains`` (or its plain version) for streams
        ``[s0, s1)`` of ``st``."""
        t = self.sticky_tables()
        s1 = st.plan.n_streams if s1 is None else s1
        return (st.streams, t.classmap, t.table, st.vend, t.packing, t.state_bits, t.absorb, s0, s1)

    def _any_absorbed(self, entries: torch.Tensor, live: np.ndarray) -> bool:
        return bool((entries.cpu().numpy()[live] == self.sticky_tables().absorb).any())

    def contains_staged(self, st: StagedStreams) -> bool:
        """True iff some live stream absorbed: one sticky scan (B3)."""
        return self._any_absorbed(dense_contains(*self.sticky_args(st)), st.live_np)

    def contains(self, text: utf8.TextLike) -> bool:
        data = utf8.to_u8(text)
        if len(data) == 0:
            return False
        return self.contains_staged(self.stage(data))

    def contains_staged_early(self, st: StagedStreams, n_segments: Optional[int] = None) -> bool:
        """``contains_staged`` as K segments of contiguous streams, in corpus
        order, answered at the first segment with a hit.  K is the largest of
        16, 8, 4, 2, 1 that is at most ``n_segments`` (by default one per
        ``CONTAINS_SEG_BYTES`` of streams) and divides the stream count.
        Every segment is queued on the current CUDA stream before the first
        answer is copied back (each copy waits for its segment only)."""
        S = st.plan.n_streams
        if n_segments is None:
            n_segments = max(1, min(16, st.plan.time_len * S // self.CONTAINS_SEG_BYTES))
        K = next((k for k in (16, 8, 4, 2) if k <= n_segments and S % k == 0), 1)
        if K == 1:
            return self.contains_staged(st)
        seg = S // K
        outs = [dense_contains(*self.sticky_args(st, k * seg, (k + 1) * seg)) for k in range(K)]
        return any(
            self._any_absorbed(o, st.live_np[k * seg : (k + 1) * seg]) for k, o in enumerate(outs)
        )

    # -- allMatches and containsAll: the hit bitmap (kernel B6) ---------------

    def bits_args(self, st: StagedStreams) -> tuple:
        """Arguments of ``matchbits`` (or its plain version): the dense
        packed-table step."""
        t = self.tables
        return (st.streams, st.warm, st.vend, "dense", t.classmap, t.table, t.packing, t.state_bits)

    def match_positions_staged(self, st: StagedStreams) -> Tuple[np.ndarray, np.ndarray]:
        """(end positions ascending, entered states) of every match, int64.

        One B6 scan writes the hit bitmap; ``torch.nonzero`` over its words
        and a gather of the non-zero words run on the device, and their
        indices and values come to the host in one copy.  The host expands
        the bits to positions inside each stream's ``[warm, vend)`` and
        replays the corpus bytes before each position to recover its state.
        """
        if st.data_np is None or self.t_tile % 32:
            raise NotImplementedError(
                "match extraction without the host corpus, or with t_tile % 32 != 0, "
                f"needs the packed-states kernel: ROADMAP item 10 ({self.STATES_KERNEL})"
            )
        _, bits = matchbits(*self.bits_args(st))
        S = bits.shape[1]
        flat = bits.reshape(-1)
        gi = torch.nonzero(flat).squeeze(1)
        gi, wvals = torch.stack([gi, flat[gi].long()]).cpu().numpy()
        pos = expand_hit_bits(
            gi // S, gi % S, wvals, st.warm_np.astype(np.int64), st.vend_np.astype(np.int64),
            st.plan.emit_len,
        )
        states = states_at_positions(self.machine, st.data_np, pos)
        order = np.argsort(pos, kind="stable")
        return pos[order], states[order]

    def matches_arrays_staged(self, st: StagedStreams) -> Tuple[np.ndarray, np.ndarray]:
        """(ends one past each match, value ids) in emission order."""
        return expand_hits(self.machine, *self.match_positions_staged(st))

    def matches_arrays(self, text: utf8.TextLike) -> Tuple[np.ndarray, np.ndarray]:
        data = utf8.to_u8(text)
        if len(data) == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.int32)
        return self.matches_arrays_staged(self.stage(data))


def _expand_hit_bits_native(t_words, s_idx, wvals, warm, vend, L):
    """Threaded C++ bit expansion (``am_expand_hit_bits``); None when the
    native library is unavailable (``expand_hit_bits`` then uses numpy)."""
    lib = utf8._native_lib()  # failure-cached: one probe per process
    if lib is None:
        return None
    tw = np.ascontiguousarray(t_words, dtype=np.int64)
    si = np.ascontiguousarray(s_idx, dtype=np.int64)
    wv = np.ascontiguousarray(np.asarray(wvals).astype(np.int64) & 0xFFFFFFFF, dtype=np.uint32)
    warm64 = np.ascontiguousarray(warm, dtype=np.int64)
    vend64 = np.ascontiguousarray(vend, dtype=np.int64)
    try:
        budget = int(np.bitwise_count(wv).sum())  # numpy >= 2.0
    except AttributeError:  # numpy 1.x
        budget = int(np.unpackbits(wv.view(np.uint8)).sum())
    out = np.empty(budget, dtype=np.int64)
    n = int(
        lib.am_expand_hit_bits(
            tw.ctypes.data, si.ctypes.data, wv.ctypes.data, len(wv),
            warm64.ctypes.data, vend64.ctypes.data,
            0, int(L), out.ctypes.data, _default_threads(),
        )
    )
    return out[:n]


def _states_at_native(machine, data: np.ndarray, pos: np.ndarray, W: int):
    """Threaded C++ replay (``am_states_at``); None when the native library
    is unavailable."""
    lib = utf8._native_lib()
    if lib is None:
        return None
    delta = np.ascontiguousarray(machine.delta, dtype=np.int32)
    data = np.ascontiguousarray(data, dtype=np.uint8)
    pos64 = np.ascontiguousarray(pos, dtype=np.int64)
    out = np.empty(len(pos64), dtype=np.int32)
    lib.am_states_at(
        delta.ctypes.data, data.ctypes.data, len(data),
        pos64.ctypes.data, len(pos64), int(W),
        out.ctypes.data, _default_threads(),
    )
    return out.astype(np.int64)


def states_at_positions(machine, data: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """Entered state at each end position, re-derived from the raw bytes.

    Exact because the state after any byte is the longest needle prefix that
    ends there, at most ``max_needle_bytes`` long: a replay from the root of
    the last ``max_needle_bytes`` bytes lands on it."""
    if len(pos) == 0:
        return np.zeros(0, dtype=np.int64)
    W = max(1, machine.max_needle_bytes)
    native = _states_at_native(machine, data, pos, W)
    if native is not None:
        return native
    flat = machine.delta.reshape(-1)
    starts = np.asarray(pos, dtype=np.int64) - W
    idt = np.int64 if machine.delta.size > (1 << 31) - 256 else np.int32
    states = np.zeros(len(pos), dtype=idt)
    for j in range(W):
        idx = starts + j
        valid = idx >= 0
        b = data[np.where(valid, idx, 0)].astype(idt)
        nxt = np.take(flat, states * 256 + b)
        states = np.where(valid, nxt.astype(idt), states)
    return states.astype(np.int64)


def expand_hit_bits(t_words, s_idx, wvals, warm, vend, L):
    """Global end positions from sparse bitmap words: word ``i`` covers time
    steps ``[32 t_words[i], 32 t_words[i] + 32)`` of stream ``s_idx[i]``;
    bits outside each stream's ``[warm, vend)`` (warm-up duplicates, pad
    hits) are dropped, and positions re-base to corpus coordinates
    ``s * L + (t - warm) + 1``.  Threaded C++ where the native library
    loads, else ``np.unpackbits`` on the little-endian byte view."""
    if len(wvals) == 0:
        return np.zeros(0, dtype=np.int64)
    native = _expand_hit_bits_native(t_words, s_idx, wvals, warm, vend, L)
    if native is not None:
        return native
    wbytes = (np.asarray(wvals, dtype=np.int64) & 0xFFFFFFFF).astype("<u4").view(np.uint8)
    j = np.flatnonzero(np.unpackbits(wbytes, bitorder="little"))
    wi = j >> 5
    t = t_words[wi] * 32 + (j & 31)
    s = s_idx[wi]
    keep = (t >= warm[s]) & (t < vend[s])
    t, s = t[keep], s[keep]
    return s * L + (t - warm[s]) + 1


__all__ = [
    "MAX_ROWS",
    "CapacityError",
    "CompressedMachine",
    "DenseAcEngine",
    "DenseTables",
    "StagedStreams",
    "StickyTables",
    "expand_hit_bits",
    "states_at_positions",
]
