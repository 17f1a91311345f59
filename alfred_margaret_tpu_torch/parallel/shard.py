"""Sharded matching over a mesh of devices: the port's ``DistributedAcEngine``.

Counterpart of ``alfred_margaret_tpu/parallel/shard.py``.  The mesh has
three axes:

* ``data``   - corpus shards (blocks of streams);
* ``seq``    - chunks of one long document, which are blocks of streams too:
  every stream re-derives its exact state from its warm-up overlap;
* ``needle`` - needle groups: the needles are split into balanced groups,
  one sub-automaton each, and every group scans the streams of its block.

Streams are laid out as in the JAX engine (same quantum, stream count and
time padding), so per-stream outputs compare one to one.  Each shard runs
its own kernel launch on its own contiguous ``[T, S_local]`` block, through
the wrappers in ``kernels/`` (the launch counts see every one):

| step | kernel | JAX launch |
| --- | --- | --- |
| dense count | B1 ``dense_count`` | ``parallel/shard.py:325`` |
| bitap count (+ trap plane) | B2 ``bitap_count`` | ``:434`` |
| bitap sticky (+ trap plane) | B4 ``bitap_contains`` | ``:509`` |
| comb16 sticky | B11's one-group mode ``comb16_contains_base`` | ``:616`` |
| comb16 count | B9 ``comb16_count_grouped`` on one group | ``:696`` |
| dense sticky | B3 ``dense_contains`` | ``:997`` |
| states | B5 ``dense_states`` | ``:1134`` |
| counts + hit bitmap | B6 ``matchbits``, dense step | ``:1219`` |

JAX's ``psum`` becomes two steps: the per-stream results of this process's
shards are summed in int64 on its first shard's device, then
``torch.distributed.all_reduce`` sums them over the processes when a
process group is initialised.  Stream blocks are disjoint, so trap planes
are placed per stream, not summed; sticky answers reduce as hit counts.
Shards may share a device: ``make_mesh(["cuda:0"] * 8, ...)`` is an
8-shard mesh on one card, ``["cpu"] * 8`` the tests' mesh, where the
kernels' plain versions run.

Left out on purpose: JAX's switch to the dense step when a backend rejects
the comb16 kernel (``shard.py:840-858``, ``:1074-1085``; here a failed
build or launch raises), and the TPU op-shaving state (``_fold``,
``_in_range``, ``_wpairs``, ``defer``).  A bitap layout takes the bitap
steps only where its words fit the port's sticky kernel (3 registers, trap
register included); a larger one, which the JAX law allows up to 8 words,
takes the dense steps.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..kernels.bitap_contains import MAX_WORDS as BITAP_STICKY_WORDS
from ..kernels.bitap_contains import bitap_contains, bitap_contains_plain
from ..kernels.bitap_count import bitap_count, bitap_count_plain
from ..kernels.comb16_grouped import (
    comb16_contains_base,
    comb16_contains_base_plain,
    comb16_count_grouped,
    comb16_count_grouped_plain,
)
from ..kernels.dense_contains import dense_contains, dense_contains_plain
from ..kernels.dense_count import dense_count, dense_count_plain, dense_states, dense_states_plain
from ..kernels.matchbits import matchbits, matchbits_plain
from ..models import ac
from ..models.ac import AcMachine
from ..models.minimize import count_minimized
from ..ops.bitap_scan import BitapAcEngine, BitapTables, host_stream_count, make_host_exact
from ..ops.comb16_scan import Comb16GroupTables, build_comb16_uniform, build_sticky16_uniform
from ..ops.comb_scan import plan_bitap_auto
from ..ops.pallas_scan import (
    CapacityError,
    CompressedMachine,
    DenseTables,
    StickyTables,
    _StickyView,
    expand_hit_bits,
    states_at_positions,
)
from ..ops.xla_scan import StreamPlan, expand_hits, extract_matches, plan_streams, stage_streams_device
from ..utils import utf8
from ..utils.device import resolve_device
from .xla_scan_local import local_scan_counts, local_scan_states

AXES = ("data", "seq", "needle")

#: Each kernel's plain torch version (the chip smoke and the tests hold a
#: shard's launch against it).
PLAIN = {
    dense_count: dense_count_plain, bitap_count: bitap_count_plain,
    bitap_contains: bitap_contains_plain, comb16_contains_base: comb16_contains_base_plain,
    comb16_count_grouped: comb16_count_grouped_plain, dense_contains: dense_contains_plain,
    dense_states: dense_states_plain, matchbits: matchbits_plain,
}


def _group() -> Tuple[int, int]:
    """(world size, rank) of the initialised process group, else (1, 0)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def init_distributed(init_method: Optional[str] = None, world_size: Optional[int] = None,
                     rank: Optional[int] = None, backend: Optional[str] = None) -> int:
    """Join a ``torch.distributed`` process group so that a mesh can span
    processes; returns the world size.

    Without ``init_method`` it is a no-op: a single process, or the group
    that exists already.  A failure with an explicit ``init_method``
    (``"tcp://localhost:<port>"``, ``"file:///..."``, ``"env://"``)
    propagates: the job is not connected.  ``backend`` defaults to gloo for
    CPU tensors and, where CUDA is available, NCCL for CUDA tensors
    (``"cpu:gloo,cuda:nccl"``), so the reduction of a CPU mesh rides gloo and
    that of a CUDA mesh NCCL.
    """
    if init_method is None or dist.is_initialized():
        return _group()[0]
    if backend is None:
        backend = "cpu:gloo,cuda:nccl" if torch.cuda.is_available() else "gloo"
    kw = {k: v for k, v in (("world_size", world_size), ("rank", rank)) if v is not None}
    dist.init_process_group(backend=backend, init_method=init_method, **kw)
    return dist.get_world_size()


@dataclass(eq=False)
class Mesh:
    """A ``[data, seq, needle]`` mesh of devices.

    ``devices`` holds a ``torch.device`` per shard (devices may repeat);
    ``ranks`` the rank of the process that runs each shard, assigned in
    contiguous blocks of the flattened mesh over the ``world_size`` processes
    of the group that existed when the mesh was made."""

    devices: np.ndarray  # object [data, seq, needle]
    ranks: np.ndarray  # int64 [data, seq, needle]
    world_size: int = 1
    axis_names: Tuple[str, ...] = AXES

    @property
    def shape(self) -> Tuple[int, int, int]:
        return tuple(self.devices.shape)


def make_mesh(devices=None, data: Optional[int] = None, seq: int = 1, needle: int = 1) -> Mesh:
    """A (data, seq, needle) mesh over ``devices`` (default: every visible
    CUDA card; raises without one).  Devices may repeat: ``["cuda:0"] * 8``
    is an 8-shard mesh on one card, ``["cpu"] * 8`` one on the CPU.  Every
    entry goes through ``utils.device.resolve_device``: nothing moves from
    CUDA to the CPU by itself."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh() with no devices needs CUDA, and "
                               "torch.cuda.is_available() is false")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = [resolve_device(d) for d in devices]
    n = len(devs)
    if data is None:
        data = n // (seq * needle)
    if data < 1 or seq < 1 or needle < 1 or data * seq * needle != n:
        raise ValueError(f"mesh {data}x{seq}x{needle} != {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    world, _ = _group()
    ranks = (np.arange(n, dtype=np.int64) * world // n).reshape(data, seq, needle)
    return Mesh(devices=arr.reshape(data, seq, needle), ranks=ranks, world_size=world)


def _balanced_groups(machine: AcMachine, n_groups: int) -> List[List[int]]:
    """Split value ids into exactly ``n_groups`` groups, duplicates together,
    balanced by total needle bytes (the JAX package's)."""
    sizes = [0] * n_groups
    groups: List[List[int]] = [[] for _ in range(n_groups)]
    first_group: dict = {}
    for vid, needle in enumerate(machine.needles):
        g = first_group.get(needle)
        if g is None:
            g = int(np.argmin(sizes))
            first_group[needle] = g
            sizes[g] += len(needle) + 1
        groups[g].append(vid)
    return groups


@dataclass
class ShardBlock:
    """One stream block on one device."""

    streams: torch.Tensor  # [T, S_local] uint8, contiguous
    warm: torch.Tensor  # int32 [S_local]
    vend: torch.Tensor  # int32 [S_local]


@dataclass
class StagedMeshCorpus:
    """A corpus laid out and sharded over the mesh once, reused by count,
    contains, matches and presence.  ``blocks`` maps ``(stream block,
    device)`` to the block this process's shards on that device scan."""

    plan: StreamPlan
    n_stream_shards: int  # stream blocks: plan.n_streams // n_stream_shards streams each
    blocks: Dict[Tuple[int, torch.device], ShardBlock] = field(repr=False)
    warm_np: np.ndarray = field(repr=False)
    #: Host copies for the match-bitmap extraction path (raw bytes for the
    #: window-DFA state re-derivation; vend for hit filtering).
    vend_np: np.ndarray = field(repr=False, default=None)
    data_np: Optional[np.ndarray] = field(repr=False, default=None)


class DistributedAcEngine:
    """Mesh-parallel Aho-Corasick matching: counts, containsAny, containsAll
    and match extraction identical to the single-device scan for any mesh
    shape.

    ``inner`` picks the per-shard body: ``"pallas"`` (the port's kernels;
    their plain versions on CPU tensors), ``"xla"`` (torch gathers, no
    kernel), or ``"auto"``: the kernels on a mesh of CUDA devices, else
    ``"xla"``.  ``sub_build`` rebuilds a needle group's sub-automaton from
    (needle, value) pairs (default ``ac.build``; ``case_dfa.compose_build``
    keeps composed IgnoreCase groups composed).  Each needle group must fit
    the dense kernel's table (``CapacityError`` otherwise), as in the JAX
    package, so both accept the same sets."""

    def __init__(self, machine: AcMachine, mesh: Mesh, inner: str = "auto", sub_build=None):
        self.machine = machine
        self.mesh = mesh
        self._sub_build = sub_build if sub_build is not None else ac.build
        data, seq, needle = mesh.shape
        self.n_stream_shards = data * seq
        self.n_needle_groups = needle
        if inner == "auto":
            inner = "pallas" if all(d.type == "cuda" for d in mesh.devices.flat) else "xla"
        if inner not in ("pallas", "xla"):
            raise ValueError(f"inner must be 'auto', 'pallas' or 'xla', got {inner!r}")
        self.inner = inner
        self.overlap = max(0, machine.max_needle_bytes - 1)

        if self.n_needle_groups > 1:
            if any(len(n) == 0 for n in machine.needles):
                # The empty needle's root-piggyback count depends on the
                # union of all groups' non-root states: per-group sums
                # undercount.  Data/seq meshes scan the full machine.
                raise ValueError(
                    "empty needle cannot be needle-sharded; use a "
                    "data/seq-only mesh for empty-needle machines"
                )
            self.vid_groups = _balanced_groups(machine, self.n_needle_groups)
            self.sub_machines = [
                self._sub_build([(machine.needles[v], machine.values[v]) for v in vids])
                for vids in self.vid_groups
            ]
        else:
            self.vid_groups = [list(range(len(machine.needles)))]
            self.sub_machines = [machine]

        self._tables: dict = {}  # (kind, group, device) -> tables on that device
        self._bitap_lay = None
        self._c16g = None
        self._sticky16 = False  # False: not built yet; None: does not fit
        self._dense_sticky = None
        self._host_exact_eng = None
        if self.inner == "pallas":
            if self.n_needle_groups == 1:
                lay = plan_bitap_auto(machine)
                if lay is not None and len(lay.all_words()) <= BITAP_STICKY_WORDS:
                    self._bitap_lay = lay
            try:
                self._comps = [CompressedMachine.from_machine(sm, force_packing=1)
                               for sm in self.sub_machines]
            except CapacityError as e:
                raise CapacityError(
                    f"{e}; shard the automaton over more 'needle' mesh devices "
                    "(each group must fit one chip's kernel table) or use "
                    "inner='xla'"
                ) from e
            self._rows = max(c.rows for c in self._comps)
            # Uniform comb16 tables for mid-tier groups, where they need fewer
            # lookups than the dense table has rows (JAX shard.py:231-253).
            if self._rows > 8:
                try:
                    c16s, stacked = build_comb16_uniform(
                        [count_minimized(sm) for sm in self.sub_machines])
                    cst = stacked["consts"]
                    if cst["rows_c"] + cst["rows_a"] + 2 < self._rows:
                        self._c16g = Comb16GroupTables.from_stacked(stacked, "cpu", c16s=c16s)
                except CapacityError:
                    self._c16g = None

    # -- the shards of this process ---------------------------------------------

    def shards(self) -> List[Tuple[int, int, torch.device]]:
        """(stream block, needle group, device) of every shard this process
        runs, in mesh order.  Raises when the process group changed since the
        mesh was made (the shards' ranks would be wrong)."""
        world, rank = _group()
        if world != self.mesh.world_size:
            raise RuntimeError(f"the mesh was made for {self.mesh.world_size} process(es); the "
                               f"process group has {world}: make the mesh after init_distributed")
        _, seq, needle = self.mesh.shape
        out = []
        for (d, s, n), r in np.ndenumerate(self.mesh.ranks):
            if r == rank:
                out.append((d * seq + s, n, self.mesh.devices[d, s, n]))
        return out

    def _home(self) -> torch.device:
        """Where this process reduces: its first shard's device."""
        sh = self.shards()
        return sh[0][2] if sh else torch.device("cpu")

    def _all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        if dist.is_available() and dist.is_initialized():
            dist.all_reduce(t)
        return t

    def _single_process(self, what: str) -> None:
        if _group()[0] > 1:
            raise NotImplementedError(
                f"{what} needs every shard in this process: per-position outputs are not "
                "gathered across processes (count and contains_any are)")

    # -- layout ---------------------------------------------------------------

    def _plan(self, n: int) -> StreamPlan:
        """Streams padded so each (data, seq) block gets whole 128-stream
        lane groups (8 on the ``xla`` inner); time padded to 128 (JAX
        ``shard.py:758-775``)."""
        pallas = self.inner == "pallas"
        quantum = self.n_stream_shards * (128 if pallas else 8)
        plan = plan_streams(n, self.overlap, n_streams=None,
                            max_streams=max(32768 if pallas else 1024, quantum))
        s = max(quantum, -(-plan.n_streams // quantum) * quantum)
        emit = -(-n // s) if n else 1
        t = emit + self.overlap
        if pallas:
            t = -(-t // 128) * 128
        return StreamPlan(n=n, n_streams=s, emit_len=emit, overlap=self.overlap, time_len=t)

    def stage(self, text: utf8.TextLike) -> Optional[StagedMeshCorpus]:
        """Lay out and shard the corpus over the mesh once: the streams are
        windowed on this process's first shard's device, and each of its
        shards' blocks is copied out contiguous onto the shard's device."""
        data = utf8.to_u8(text)
        if len(data) == 0:
            return None
        plan = self._plan(len(data))
        home = self._home()
        streams, warm, vend = stage_streams_device(data, plan, home)
        SL = plan.n_streams // self.n_stream_shards
        blocks = {}
        for i, _, dev in self.shards():
            if (i, dev) not in blocks:
                a, b = i * SL, (i + 1) * SL
                blocks[(i, dev)] = ShardBlock(
                    streams=streams[:, a:b].to(dev).contiguous(),
                    warm=torch.from_numpy(warm[a:b].copy()).to(dev),
                    vend=torch.from_numpy(vend[a:b].copy()).to(dev),
                )
        return StagedMeshCorpus(plan=plan, n_stream_shards=self.n_stream_shards, blocks=blocks,
                                warm_np=warm, vend_np=vend, data_np=data)

    def _staged_of(self, text) -> Optional[StagedMeshCorpus]:
        """``text`` staged, or the staging it is, when this engine can scan
        it: the plan of an engine with the same mesh layout and a warm-up that
        covers this machine's needles (another machine's staging may do), and
        a block for each of this process's shards; else ``ValueError``."""
        if text is None:
            return None
        if not isinstance(text, StagedMeshCorpus):
            return self.stage(text)
        if (text.n_stream_shards != self.n_stream_shards or text.plan.overlap < self.overlap
                or any((i, dev) not in text.blocks for i, _, dev in self.shards())):
            raise ValueError("the corpus was staged for another mesh layout or a shorter warm-up")
        return text

    # -- tables per group and device ----------------------------------------------

    def _cached(self, kind: str, g: int, dev, make):
        key = (kind, g, dev)
        if key not in self._tables:
            self._tables[key] = make()
        return self._tables[key]

    def _dense(self, g: int, dev) -> DenseTables:
        return self._cached("dense", g, dev, lambda: DenseTables.from_compressed(
            self._comps[g], dev, max(0, self.sub_machines[g].max_needle_bytes - 1)))

    def _dense_sticky_rows(self) -> int:
        """Rows of the widest group's sticky view (raises ``CapacityError``
        where one overflows the table, as the JAX step does)."""
        if self._dense_sticky is None:
            svs = [_StickyView(sm) for sm in self.sub_machines]
            comps = [CompressedMachine.from_machine(sv, force_packing=1) for sv in svs]
            self._dense_sticky = (comps, [sv.absorb * c.k for sv, c in zip(svs, comps)])
        return max(c.rows for c in self._dense_sticky[0])

    def _sticky(self, g: int, dev) -> StickyTables:
        self._dense_sticky_rows()
        comps, absorbs = self._dense_sticky

        def make():
            t = DenseTables.from_compressed(comps[g], dev,
                                            max(0, self.sub_machines[g].max_needle_bytes - 1))
            return StickyTables(**t.__dict__, absorb=absorbs[g])

        return self._cached("sticky", g, dev, make)

    def _xla_tables(self, g: int, dev):
        """Group ``g``'s full byte DFA (int64 ``[n_states * 256]``) and
        per-state counts on ``dev``, for the ``xla`` inner."""
        sm = self.sub_machines[g]
        return self._cached("xla", g, dev, lambda: tuple(
            torch.from_numpy(np.ascontiguousarray(x, dtype=np.int64).reshape(-1)).to(dev)
            for x in (sm.delta, sm.match_count)))

    def _bitap(self, dev) -> BitapTables:
        return self._cached("bitap", 0, dev, lambda: BitapTables.from_layout(self._bitap_lay, dev))

    def _sticky16_tables(self) -> Optional[Comb16GroupTables]:
        """The uniform comb16 sticky tables of every group (host copy), or
        None when no single field split fits every group's sticky view."""
        if self._sticky16 is False:
            try:
                c16s, stacked = build_sticky16_uniform(self.sub_machines)
                self._sticky16 = Comb16GroupTables.from_stacked(stacked, "cpu", sticky=True,
                                                                c16s=c16s)
            except CapacityError:
                self._sticky16 = None
        return self._sticky16

    # -- the per-shard steps --------------------------------------------------------

    def _use_bitap(self, use_bitap: bool) -> bool:
        return self.inner == "pallas" and use_bitap and self._bitap_lay is not None

    def count_route(self, use_bitap: bool = True) -> str:
        """The count step: ``"bitap"`` (B2), ``"comb16"`` (B9, one group),
        ``"dense"`` (B1) or ``"xla"`` (no kernel)."""
        if self.inner != "pallas":
            return "xla"
        if self._use_bitap(use_bitap):
            return "bitap"
        return "comb16" if self._c16g is not None else "dense"

    def sticky_route(self, use_bitap: bool = True) -> str:
        """The sticky step: ``"bitap"`` (B4), ``"comb16"`` (B11's one-group
        mode, where its lookups beat the dense sticky table's rows) or
        ``"dense"`` (B3); ``"xla"`` answers through the count."""
        if self.inner != "pallas":
            return "xla"
        if self._use_bitap(use_bitap):
            return "bitap"
        rows = self._dense_sticky_rows()
        if self._c16g is not None:
            s16 = self._sticky16_tables()
            if s16 is not None and s16.comb.shape[1] // 128 + s16.aux.shape[1] // 128 + 2 < rows:
                return "comb16"
        return "dense"

    def shard_call(self, step: str, staged: StagedMeshCorpus, i: int, g: int, dev,
                   use_bitap: bool = True):
        """``(kernel, args, kw)`` of one shard's launch: ``step`` is
        ``"count"``, ``"sticky"``, ``"states"`` or ``"bits"``, on stream block
        ``i``, needle group ``g``, device ``dev``; the launch is
        ``kernel(*args, **kw)`` (``kw`` holds the ``overlap`` of B1, B2, B3,
        B4, B5 and B6; B9 and B11 take theirs in ``args``), and
        ``PLAIN[kernel](*args, **kw)`` is the same function by the kernel's
        plain version.  The ``xla`` inner has no kernel: ``(None, ..., {})``.
        Raises ``ValueError`` where the staging's overlap is too short for a
        segmented step's tables (S2, S3, S6, S7)."""
        blk = staged.blocks[(i, dev)]
        if step == "count":
            route = self.count_route(use_bitap)
            if route == "xla":
                return None, (*self._xla_tables(g, dev), blk.streams, blk.warm, blk.vend), {}
            if route == "bitap":
                t = self._bitap(dev)
                t.check_overlap(staged.plan.overlap)
                args = (blk.streams, t.btab, t.seed, t.endmask, t.field_start, t.field_bit,
                        t.field_weight, blk.warm, t.trapmask)
                return bitap_count, args, {"overlap": staged.plan.overlap}
            if route == "comb16":
                tabs = self._cached("c16", g, dev, lambda: self._c16g.group(g, dev))
                return comb16_count_grouped, (blk.streams, blk.warm, blk.vend, tabs,
                                              staged.plan.overlap), {}
            t = self._dense(g, dev)
            return dense_count, (blk.streams, t.classmap, t.table, blk.warm, blk.vend,
                                 t.packing, t.state_bits), {"overlap": staged.plan.overlap}
        if step == "sticky":
            route = self.sticky_route(use_bitap)
            if route == "bitap":
                t = self._bitap(dev)
                t.check_overlap(staged.plan.overlap)
                args = (blk.streams, t.btab, t.seed, t.endmask, t.trapmask)
                return bitap_contains, args, {"overlap": staged.plan.overlap}
            if route == "comb16":
                tabs = self._cached("s16", g, dev, lambda: self._sticky16_tables().group(g, dev))
                return comb16_contains_base, (blk.streams, blk.vend, tabs, staged.plan.overlap), {}
            if route == "dense":
                t = self._sticky(g, dev)
                t.check_overlap(staged.plan.overlap)
                return dense_contains, (blk.streams, t.classmap, t.table, blk.vend, t.packing,
                                        t.state_bits, t.absorb), {"overlap": staged.plan.overlap}
            raise ValueError("the xla inner has no sticky step")
        if step == "states":
            if self.inner != "pallas":
                return None, (self._xla_tables(g, dev)[0], blk.streams), {}
            t = self._dense(g, dev)
            t.check_overlap(staged.plan.overlap)
            return dense_states, (blk.streams, t.classmap, t.table, t.packing, t.state_bits), {
                "overlap": staged.plan.overlap}
        if step == "bits":
            t = self._dense(g, dev)
            return matchbits, (blk.streams, blk.warm, blk.vend, "dense", t.classmap, t.table,
                               t.packing, t.state_bits), {"overlap": staged.plan.overlap}
        raise ValueError(f"unknown step {step!r}")

    def _launch(self, step, staged, i, g, dev, use_bitap=True):
        kernel, args, kw = self.shard_call(step, staged, i, g, dev, use_bitap)
        if kernel is not None:
            return kernel(*args, **kw)
        return local_scan_counts(*args) if step == "count" else local_scan_states(*args)

    def _blocks_range(self, staged, i: int) -> Tuple[int, int]:
        SL = staged.plan.n_streams // self.n_stream_shards
        return i * SL, (i + 1) * SL

    # -- the reductions ---------------------------------------------------------------

    def stream_counts(self, staged: StagedMeshCorpus, use_bitap: bool = True) -> np.ndarray:
        """int64 per-stream counts of the whole mesh, summed over the needle
        groups: ``[S]``, or for a trap-bearing bitap layout ``[2, S]``
        (counts, trap plane), every plane placed per stream.  Fully padded
        streams count 0."""
        S = staged.plan.n_streams
        home = self._home()
        trap = self.count_route(use_bitap) == "bitap" and self._bitap_lay.has_trap
        out = torch.zeros((2, S) if trap else (S,), dtype=torch.int64, device=home)
        for i, g, dev in self.shards():
            a, b = self._blocks_range(staged, i)
            live = staged.blocks[(i, dev)].vend > 0
            res = self._launch("count", staged, i, g, dev, use_bitap)
            if trap:
                counts, tr = res
                out[0, a:b] += torch.where(live, counts, 0).to(home, torch.int64)
                out[1, a:b] = torch.where(live, tr, 0).to(home, torch.int64)
            else:
                out[a:b] += torch.where(live, res, 0).to(home, torch.int64)
        return self._all_reduce(out).cpu().numpy()

    def sticky_hits(self, staged: StagedMeshCorpus, use_bitap: bool = True):
        """Sticky hits of the whole mesh: an int64 count of (stream, group)
        pairs that saw a match, or for a trap-bearing bitap layout the
        ``[2, S]`` planes (hits, trap) placed per stream."""
        route = self.sticky_route(use_bitap)
        home = self._home()
        trap = route == "bitap" and self._bitap_lay.has_trap
        out = torch.zeros((2, staged.plan.n_streams) if trap else (), dtype=torch.int64,
                          device=home)
        for i, g, dev in self.shards():
            live = staged.blocks[(i, dev)].vend > 0
            res = self._launch("sticky", staged, i, g, dev, use_bitap)
            if trap:
                a, b = self._blocks_range(staged, i)
                out[0, a:b] = torch.where(live, res[0], 0).to(home, torch.int64)
                out[1, a:b] = torch.where(live, res[1], 0).to(home, torch.int64)
                continue
            if route == "bitap":
                hit = res != 0
            elif route == "comb16":
                hit = res == int(self._sticky16_tables().gscal[g, 1])  # the absorbing base
            else:
                hit = res == self._sticky(g, dev).absorb
            out += (hit & live).sum().to(home, torch.int64)
        out = self._all_reduce(out).cpu()
        return out.numpy() if trap else int(out)

    # -- count ----------------------------------------------------------------

    def count_staged(self, staged: Optional[StagedMeshCorpus]) -> int:
        """The total count: the count step's per-stream counts summed in
        int64, the trapped streams of a trap-bearing layout recovered."""
        staged = self._staged_of(staged)
        if staged is None:
            return 0
        res = self.stream_counts(staged)
        if res.ndim == 2:
            counts, trap = res
            if (trap != 0).any():
                # A length-changing unlowering occurs: re-count only the
                # trapped streams on the host, or re-scan with the dense step.
                fixed = self._localized_trap_counts(staged, counts, trap)
                if fixed is not None:
                    return fixed
                return int(self.stream_counts(staged, use_bitap=False).sum())
            return int(counts.sum())
        return int(res.sum())

    def count(self, text) -> int:
        return self.count_staged(text)

    # -- localized IgnoreCase trap recovery (JAX shard.py:865-914) -------------------

    def _trapped_stream_idx(self, staged, trap: np.ndarray):
        """Trapped live stream ids, or None when the dense re-scan is the
        cheaper recovery (the single-device engine's budget,
        ``BitapAcEngine.TRAP_LOCAL_FRAC``) or there is no host corpus."""
        idx = np.flatnonzero(trap.reshape(-1) != 0)
        if len(idx) == 0 or staged.data_np is None:
            return None if len(idx) else idx
        live_n = int((staged.vend_np > 0).sum())
        if len(idx) > max(32, int(live_n * BitapAcEngine.TRAP_LOCAL_FRAC)):
            return None
        return idx

    def _host_trap_count(self, staged, s: int) -> int:
        if self._host_exact_eng is None:
            self._host_exact_eng = make_host_exact(self.machine)
        return host_stream_count(self.machine, self._host_exact_eng, staged.data_np,
                                 staged.plan.emit_len, staged.plan.n, staged.warm_np[s], s)

    def _localized_trap_counts(self, staged, counts: np.ndarray, trap: np.ndarray):
        idx = self._trapped_stream_idx(staged, trap)
        if idx is None:
            return None
        fixed = counts.astype(np.int64).reshape(-1)
        for s in idx:
            fixed[s] = self._host_trap_count(staged, int(s))
        return int(fixed.sum())

    def _localized_trap_contains(self, staged, trap: np.ndarray):
        idx = self._trapped_stream_idx(staged, trap)
        if idx is None:
            return None
        return any(self._host_trap_count(staged, int(s)) > 0 for s in idx)

    # -- containsAny ------------------------------------------------------------

    def contains_any(self, text) -> bool:
        """Mesh-wide existence: the sticky step on every shard (no counts);
        the ``xla`` inner answers through the count."""
        staged = self._staged_of(text)
        if staged is None:
            return False
        if self.inner != "pallas":
            return self.count_staged(staged) > 0
        res = self.sticky_hits(staged)
        if isinstance(res, np.ndarray):
            hits, trap = res
            if (hits != 0).any():
                return True  # a track hit is a match even under traps
            if (trap != 0).any():
                got = self._localized_trap_contains(staged, trap)
                if got is not None:
                    return got
                return self.sticky_hits(staged, use_bitap=False) > 0
            return False
        return res > 0

    def contains_staged(self, staged: Optional[StagedMeshCorpus]) -> bool:
        return self.contains_any(staged)

    # -- positions --------------------------------------------------------------

    def states_per_group(self, staged: StagedMeshCorpus) -> np.ndarray:
        """int32 [G, T, S]: per-position states of every needle group (the
        whole machine when the needle axis is trivial)."""
        self._single_process("per-position states")
        plan = staged.plan
        out = np.zeros((self.n_needle_groups, plan.time_len, plan.n_streams), dtype=np.int32)
        for i, g, dev in self.shards():
            a, b = self._blocks_range(staged, i)
            res = self._launch("states", staged, i, g, dev)
            if self.inner == "pallas":
                c = self._comps[g]
                res = (res.long() & c.state_mask) // c.k
            out[g, :, a:b] = res.to(torch.int32).cpu().numpy()
        return out

    def bits_per_group(self, staged: StagedMeshCorpus):
        """([G, S] int64 per-stream counts, [G, T // 32, S] int32 hit bitmaps)
        from one scan per shard (B6's dense step), or None where the bitmap
        route is unavailable (the ``xla`` inner, no host corpus)."""
        plan = staged.plan
        if self.inner != "pallas" or plan.time_len % 32 or staged.data_np is None:
            return None
        self._single_process("the hit bitmap")
        G, T, S = self.n_needle_groups, plan.time_len, plan.n_streams
        counts = np.zeros((G, S), dtype=np.int64)
        bits = np.zeros((G, T // 32, S), dtype=np.int32)
        for i, g, dev in self.shards():
            a, b = self._blocks_range(staged, i)
            c, w = self._launch("bits", staged, i, g, dev)
            counts[g, a:b] = c.long().cpu().numpy()
            bits[g, :, a:b] = w.cpu().numpy()
        return counts, bits

    def _hits_per_group(self, staged: StagedMeshCorpus):
        """Per needle group: (end positions ascending, entered states) from
        the hit bitmaps, the states re-derived from the raw bytes; None where
        the bitmap route is unavailable."""
        got = self.bits_per_group(staged)
        if got is None:
            return None
        counts_np, bits_np = got
        warm = staged.warm_np.astype(np.int64)
        vend = staged.vend_np.astype(np.int64)
        L = staged.plan.emit_len
        out = []
        for g, sub in enumerate(self.sub_machines):
            bits = bits_np[g]
            w, s = np.nonzero(bits)
            if len(w) == 0:
                out.append((np.zeros(0, np.int64), np.zeros(0, np.int64)))
                continue
            vals = bits[w, s].astype(np.int64) & 0xFFFFFFFF
            pos = expand_hit_bits(w, s, vals, warm, vend, L)
            states = states_at_positions(sub, staged.data_np, pos)
            # The matches at the hit positions must be the kernel's count
            # exactly (one bit can carry several matches).
            n_hits, n_kernel = int(sub.match_count[states].sum()), int(counts_np[g].sum())
            if n_hits != n_kernel:
                raise RuntimeError(f"mesh bitmap/count mismatch in group {g}: "
                                   f"{n_hits} matches at the hit positions, kernel {n_kernel}")
            order = np.argsort(pos, kind="stable")
            out.append((pos[order], states[order].astype(np.int64)))
        return out

    def _assemble_flat(self, staged: StagedMeshCorpus, states_ts: np.ndarray) -> np.ndarray:
        """Per-position states in corpus order from one group's [T, S]."""
        plan, warm = staged.plan, staged.warm_np
        n, S, L = plan.n, plan.n_streams, plan.emit_len
        flat = np.empty(n, dtype=np.int32)
        for i in range(S):
            emit_begin = i * L
            if emit_begin >= n:
                break
            emit_end = min(emit_begin + L, n)
            flat[emit_begin:emit_end] = states_ts[warm[i]: warm[i] + (emit_end - emit_begin), i]
        return flat

    def matches_arrays(self, text):
        """(ends, value_ids) identical to the single-device scan for any mesh
        shape: each group's hits (bitmap route) or per-position states, and
        across groups a merge by ``(end, -needle length)``, the reference's
        same-end emission order (own longest needle first, then shorter
        failure-chain suffixes; same-end same-length needles are equal bytes,
        hence in one group)."""
        staged = self._staged_of(text)
        if staged is None:
            return np.zeros(0, np.int64), np.zeros(0, np.int32)
        self._single_process("matches_arrays")
        hits = self._hits_per_group(staged)
        states_g = None if hits is not None else self.states_per_group(staged)
        all_ends, all_vids = [], []
        for g, sub in enumerate(self.sub_machines):
            if hits is not None:
                ends, local_vids = expand_hits(sub, *hits[g])
            else:
                ends, local_vids = extract_matches(sub, self._assemble_flat(staged, states_g[g]))
            all_ends.append(ends)
            all_vids.append(np.asarray(self.vid_groups[g], dtype=np.int64)[local_vids])
        ends = np.concatenate(all_ends)
        vids = np.concatenate(all_vids)
        if len(ends) == 0 or self.n_needle_groups == 1:
            return ends.astype(np.int64), vids.astype(np.int32)
        lens = np.fromiter((len(self.machine.needles[int(v)]) for v in vids), np.int64, len(vids))
        order = np.lexsort((-lens, ends))
        return ends[order].astype(np.int64), vids[order].astype(np.int32)

    def matches_arrays_staged(self, staged: Optional[StagedMeshCorpus]):
        return self.matches_arrays(staged)

    def value_presence(self, text, n_values: Optional[int] = None) -> np.ndarray:
        """bool [n_values]: which values matched anywhere on the mesh."""
        if n_values is None:
            n_values = len(self.machine.values)
        present = np.zeros(n_values, dtype=bool)
        staged = self._staged_of(text)
        if staged is None:
            return present
        self._single_process("value_presence")
        hits = self._hits_per_group(staged)
        states_g = None if hits is not None else self.states_per_group(staged)
        for g, sub in enumerate(self.sub_machines):
            if hits is not None:
                hit_states = hits[g][1]
            else:
                flat = self._assemble_flat(staged, states_g[g])
                hit_states = flat[sub.match_count[flat] > 0]
            subp = ac.presence_of_states(sub, hit_states, len(sub.values))
            present[np.asarray(self.vid_groups[g], dtype=np.int64)[np.flatnonzero(subp)]] = True
        return present

    def contains_all(self, text) -> bool:
        """Distributed ``containsAll`` (``AhoCorasick/Searcher.hs:173-187``)."""
        return bool(self.value_presence(text).all())


__all__ = [
    "PLAIN",
    "DistributedAcEngine",
    "Mesh",
    "ShardBlock",
    "StagedMeshCorpus",
    "init_distributed",
    "make_mesh",
]
