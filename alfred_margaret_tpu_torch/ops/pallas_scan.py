"""Dense DFA count engine over the hand-written CUDA kernel B1.

Counterpart of ``alfred_margaret_tpu/ops/pallas_scan.py``:
``CapacityError``, ``_zero_inert``, ``CompressedMachine.from_machine`` and
``StagedStreams`` are copied as numpy (that module imports ``jax``;
``tests/test_torch_layout.py`` pins the copies to the originals), and
``DenseAcEngine`` takes the place of ``PallasAcEngine`` for ``stage``,
``adopt_staged``, ``count_staged`` and ``count``.  The TPU-only parts are
left out: the ``reps`` re-scan grid and the ``defer``/``nomask``/``fold``/
``wpairs`` variants, which shave vector operations on the TPU.

The automaton is compressed to k byte classes and packed into
``packed[state * k + cls] = count << state_bits | next_state * k`` so that a
step is one class lookup and one table lookup (``kernels/dense_count.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from alfred_margaret_tpu.models.ac import AcMachine
from alfred_margaret_tpu.utils import utf8

from ..kernels.dense_count import dense_count, dense_count_plain
from ..utils.device import resolve_device
from .xla_scan import StreamPlan, stage_streams_device

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


class DenseAcEngine:
    """Counts all matches of ``machine`` with the dense DFA kernel on ``device``.

    ``n_streams`` streams (S) of ``ceil(n / S)`` emission bytes each, time
    padded to a ``t_tile`` multiple: the same stream plan as
    ``PallasAcEngine`` with the same arguments, so per-stream counts compare
    one to one.  Raises ``CapacityError`` when the packed table exceeds
    ``MAX_ROWS`` rows.
    """

    def __init__(self, machine: AcMachine, *, device, n_streams: int = 32768, t_tile: int = 128):
        if n_streams < 1 or t_tile < 1:
            raise ValueError("n_streams and t_tile must be positive")
        self.machine = machine
        self.device = resolve_device(device)
        self.comp = CompressedMachine.from_machine(machine)
        self.tables = DenseTables.from_compressed(self.comp, self.device)
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


__all__ = [
    "MAX_ROWS",
    "CapacityError",
    "CompressedMachine",
    "DenseAcEngine",
    "DenseTables",
    "StagedStreams",
]
