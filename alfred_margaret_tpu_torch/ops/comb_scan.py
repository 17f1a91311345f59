"""32-bit row-displacement comb engine over the hand-written CUDA kernels
B15, B16 and B17, and the port's engine dispatcher.

Counterpart of ``alfred_margaret_tpu/ops/comb_scan.py``: ``CombMachine``,
``_choose_classes``, ``_center_candidates``, ``_mism_matrix``,
``comb_structure_cost``, ``build_comb`` and ``plan_pallas`` are copied as
numpy (that module imports ``jax``; ``tests/test_torch_comb.py``,
``tests/test_torch_comb16.py`` and ``tests/test_torch_grouped.py`` pin the
copies), ``CombAcEngine`` takes the place of ``CombPallasAcEngine``, and
``make_engine`` that of ``make_pallas_engine``.

A DFA-ized Aho-Corasick row is the row of its failure state off trie edges.
The comb build keeps D dense default rows (the root and the most popular
failure targets) and places only each state's exceptions to its default row
in one comb array, at ``base(s) + class`` by first fit; each comb entry keeps
the low bits of its owner's base, which tells a hit from a slot of another
state exactly.  A state is carried as ``(base, default row)``; see
``kernels/comb.py`` for the step.  The count and containsAny kernels scan
the count-minimized machine's tables, and the packed-states kernel B17 the
full machine's, whose bases name the states; as in the JAX package this
engine has no hit bitmap, so ``match_positions_staged`` runs B15 (whose
count, where zero, skips the rest) and B17, and compacts B17's entries on
the device (``pallas_scan.compact_packed``); ``final_states`` stitches B17's
entries.  The TPU-only parts are left out: the ``reps`` re-scan grid, the
``fold``/``wpairs`` class lookups and the boundary-tile split.

The dispatcher.  The JAX package ranks its engines by the TPU's table
gathers per byte (``plan_pallas``) and weighs bitap against them with a word
budget measured on the TPU (``bitap_word_budget``, at least 2 words).
Neither law holds on the H100: the dense kernel does one shared-memory
lookup per byte whatever its row count, comb16 three or four dependent ones.
So the port takes bitap up to that floor of 2 words (every set the port
sends to bitap, the JAX package sends to bitap too), then dense wherever its
table fits, then comb16, then comb32, which holds the sets whose full
machine overflows comb16 (as ``make_pallas_engine`` falls from comb16 to
comb32).  Re-deriving the order from H100 numbers is ROADMAP Queue A item 7.
``plan_pallas`` and ``comb_structure_cost`` keep the TPU's cost currency all
the same: they only shape the grouped engine's partition
(``ops/grouped.py:partition_adaptive``), which must give the JAX package's
groups.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..kernels.comb import comb_contains, comb_count, comb_count_plain, comb_states
from ..models.ac import AcMachine
from ..models.minimize import count_minimized, minimize_sticky
from .bitap_scan import BitapAcEngine, BitapLayout, plan_bitap, plan_bitap_ci
from .pallas_scan import (
    MAX_ROWS,
    CapacityError,
    CompressedMachine,
    DenseAcEngine,
    StagedStreams,
    _StickyView,
)

#: Registers per stream the dispatcher gives bitap: the floor of the JAX
#: package's ``bitap_word_budget``.
BITAP_MAX_WORDS = 2

#: The comb32 entry layout (the JAX package's): a 13-bit base, the match
#: count in bits 30..27 (at most 15).
BASE_BITS = 13
BASE_MASK = (1 << BASE_BITS) - 1
COUNT_SHIFT = 27
MAX_COUNT = 15


@dataclass
class CombMachine:
    """Row-displacement-compressed automaton arrays (host side)."""

    classmap: np.ndarray  # int32 [256] byte -> class
    comb: np.ndarray  # int32 [rows_c * 128] displaced exception entries
    def_table: np.ndarray  # int32 [rows_d * 128] D dense default rows (D*k used)
    base: np.ndarray  # int32 [n_states] unique base per state
    def_idx: np.ndarray  # int32 [n_states]
    inv_base: np.ndarray  # int32 [1 << BASE_BITS] base -> state (-1 empty)
    n_states: int
    k: int
    D: int
    rows_c: int
    rows_d: int
    owner_bits: int
    def_bits: int
    n_exceptions: int

    @property
    def owner_shift(self) -> int:
        return BASE_BITS + self.def_bits

    @property
    def owner_mask(self) -> int:
        return (1 << self.owner_bits) - 1

    @property
    def def_mask(self) -> int:
        return (1 << self.def_bits) - 1

    @property
    def rows_total(self) -> int:
        return self.rows_c + self.rows_d

    def pack_entry(self, target: np.ndarray, mc: np.ndarray, owner_res) -> np.ndarray:
        return (
            (mc[target].astype(np.int64) << COUNT_SHIFT)
            | (np.asarray(owner_res, dtype=np.int64) << self.owner_shift)
            | (self.def_idx[target].astype(np.int64) << BASE_BITS)
            | self.base[target].astype(np.int64)
        )

    def resolve_classes(self, states: np.ndarray, classes: np.ndarray):
        """Vectorized one-step resolution: (next_state, count) per element
        (the host oracle of the kernels' step)."""
        w = self.base[states].astype(np.int64) + classes
        m = self.rows_c * 128
        v = self.comb[np.minimum(w, m - 1)]
        own_ok = ((v >> self.owner_shift) & self.owner_mask) == (
            self.base[states] & self.owner_mask
        )
        hit = own_ok & (w < m)
        r = self.def_table[self.def_idx[states].astype(np.int64) * self.k + classes]
        pk = np.where(hit, v, r)
        nxt = self.inv_base[pk & BASE_MASK]
        return nxt, pk >> COUNT_SHIFT


def _choose_classes(delta: np.ndarray):
    cols = np.ascontiguousarray(delta.T)
    uniq, inv = np.unique(cols, axis=0, return_inverse=True)
    return uniq.T.astype(np.int64), inv.astype(np.int32)  # comp [S,k], classmap


def _center_candidates(machine, S: int, d_max: int) -> np.ndarray:
    """Default-row candidate states: root first, then the most popular
    failure-link targets (``delta(s,c) == delta(fail(s),c)`` off trie edges,
    so popular fail targets make the best shared default rows)."""
    fail = machine.fail
    if fail is None:
        order = np.arange(S)
    else:
        indeg = np.bincount(np.asarray(fail, dtype=np.int64), minlength=S)
        indeg[0] = 1 << 60
        order = np.argsort(-indeg, kind="stable")
    cand = [0]
    for s in order:
        if int(s) != 0:
            cand.append(int(s))
        if len(cand) >= d_max:
            break
    return np.asarray(cand[:d_max], dtype=np.int64)


def _mism_matrix(comp: np.ndarray, cand: np.ndarray) -> np.ndarray:
    """mism[s, j] = #classes where state s's row differs from candidate j's
    (accumulated class-by-class: small temporaries, ~4x faster than one big
    broadcast)."""
    c32 = comp.astype(np.int32)
    cc = np.ascontiguousarray(c32[cand])  # [C, k]
    S, k = c32.shape
    mm = np.zeros((S, len(cand)), dtype=np.int16)
    for c in range(k):
        mm += c32[:, c : c + 1] != cc[None, :, c]
    return mm


def comb_structure_cost(
    machine,
    d_candidates=(1, 8, 32, 128, 512),
    overhead: float = 1.08,
    max_rows: Optional[int] = None,
):
    """Estimate (rows_total, D, exc) for comb-compressing ``machine`` without
    doing placement: the grouped partitioner's budget search.

    Centers are root + the most popular failure targets; each state is
    assigned the center minimizing its exception count (vectorized prefix
    min, so all candidate D values are scored in one pass).  ``max_rows``
    prunes D values whose dense default table alone would blow the budget.
    """
    comp, classmap = _choose_classes(machine.delta)
    S, k = comp.shape
    if k < 1:
        raise CapacityError("degenerate class count")
    owner_bits = max(1, int(np.ceil(np.log2(k + 1))))
    def_bits = 14 - owner_bits
    if def_bits < 0:
        raise CapacityError(f"k={k} leaves no def_idx bits")
    d_max = 1 << def_bits
    ds = sorted(set(min(d, d_max) for d in d_candidates))
    if max_rows is not None:
        ds = [d for d in ds if -(-d * k // 128) < max_rows] or [1]
    cand = _center_candidates(machine, S, ds[-1])
    run_min = np.minimum.accumulate(_mism_matrix(comp, cand), axis=1)
    results = []
    for D in ds:
        D = min(D, len(cand))
        exc = int(run_min[:, D - 1].sum(dtype=np.int64))
        # Physical positions serve double duty (one base AND one exception
        # slot each), so capacity is bounded by the larger of the two
        # demands: exception count, and the number of states needing a
        # unique in-range base (placement achieves ~0.85 density on both).
        s_exc = int((run_min[:, D - 1] > 0).sum())
        need = max(int(exc * overhead), int(s_exc * 1.15))
        rows_c = max(1, -(-need // 128))
        rows_d = -(-D * k // 128)
        results.append((rows_c + rows_d, D, exc))
    results.sort()
    return results[0]


def build_comb(
    machine,
    max_rows_total: int = MAX_ROWS,
    d_candidates=(1, 8, 32, 128, 512),
) -> CombMachine:
    """Build a :class:`CombMachine`; raises :class:`CapacityError` when the
    machine cannot fit ``max_rows_total`` physical rows."""
    comp, classmap = _choose_classes(machine.delta)
    S, k = comp.shape
    mc = np.asarray(machine.match_count, dtype=np.int64)
    if mc.max(initial=0) > MAX_COUNT:
        raise CapacityError("per-state match count exceeds 4-bit comb field")
    owner_bits = max(1, int(np.ceil(np.log2(k + 1))))
    def_bits = 14 - owner_bits
    if def_bits < 0:
        raise CapacityError(f"k={k} leaves no def_idx bits")

    # --- center choice + per-state default assignment --------------------
    _, D, _ = comb_structure_cost(machine, d_candidates, max_rows=max_rows_total)
    centers = _center_candidates(machine, S, D)
    D = len(centers)
    # def_idx[s] = argmin mismatches against the chosen centers.
    mm = _mism_matrix(comp, centers)
    def_of = mm.argmin(1).astype(np.int32)
    exc_cnt = mm.min(1).astype(np.int64)
    total_exc = int(exc_cnt.sum())

    # --- first-fit placement of exception rows ----------------------------
    m_cap = min(max_rows_total * 128, (1 << BASE_BITS))
    occ = np.zeros(m_cap + k, dtype=bool)  # slack tail simplifies shifts
    base = np.full(S, -1, dtype=np.int32)
    base_used = np.zeros(1 << BASE_BITS, dtype=bool)
    exc_classes: List[Optional[np.ndarray]] = [None] * S
    owners_order = np.argsort(-exc_cnt, kind="stable")
    high_water = 0
    for s in owners_order:
        s = int(s)
        if exc_cnt[s] == 0:
            break
        e = np.nonzero(comp[s] != comp[centers[def_of[s]]])[0]
        exc_classes[s] = e
        bad = np.zeros(m_cap, dtype=bool)
        for c in e:
            bad |= occ[c : c + m_cap]
        bad |= base_used[:m_cap]
        free = np.nonzero(~bad)[0]
        if len(free) == 0:
            raise CapacityError("comb placement overflow")
        b = int(free[0])
        if b + int(e[-1]) >= m_cap:
            raise CapacityError("comb placement overflow")
        base[s] = b
        base_used[b] = True
        occ[b + e] = True
        high_water = max(high_water, b + int(e[-1]) + 1)

    rows_c = max(1, -(-high_water // 128))
    if rows_c > max_rows_total:
        raise CapacityError(f"comb needs {rows_c} rows > budget")
    m_pad = rows_c * 128
    rows_d = -(-D * k // 128)
    if rows_c + rows_d > max_rows_total:
        raise CapacityError(
            f"comb rows {rows_c}+{rows_d} exceed budget {max_rows_total}"
        )

    # Exception-less states: unique out-of-range bases (guaranteed misses
    # via the kernel's ``w < m_pad`` guard).
    next_dummy = (1 << BASE_BITS) - 1
    for s in range(S):
        if base[s] >= 0:
            continue
        while next_dummy >= m_pad and base_used[next_dummy]:
            next_dummy -= 1
        if next_dummy < m_pad:
            raise CapacityError("ran out of dummy base values")
        base[s] = next_dummy
        base_used[next_dummy] = True

    inv_base = np.full(1 << BASE_BITS, -1, dtype=np.int32)
    inv_base[base] = np.arange(S, dtype=np.int32)

    cm = CombMachine(
        classmap=classmap,
        comb=np.zeros(m_pad, dtype=np.int64),  # finalized to int32 below
        def_table=np.zeros(rows_d * 128, dtype=np.int64),
        base=base,
        def_idx=def_of,
        inv_base=inv_base,
        n_states=S,
        k=k,
        D=D,
        rows_c=rows_c,
        rows_d=rows_d,
        owner_bits=owner_bits,
        def_bits=def_bits,
        n_exceptions=total_exc,
    )

    # --- fill entries ------------------------------------------------------
    tmask = cm.owner_mask
    comb = np.zeros(m_pad, dtype=np.int64)
    slot_owner = np.full(m_pad, -1, dtype=np.int64)
    for s in owners_order:
        s = int(s)
        e = exc_classes[s]
        if e is None:
            break
        w = base[s] + e
        comb[w] = cm.pack_entry(comp[s, e], mc, base[s] & tmask)
        slot_owner[w] = base[s]
    # Empty slots: an owner residue distinct from every in-window owner base.
    # Only a base in the probe window (w-k, w] can reach slot w (via class
    # c = w - base); such bases have pairwise-distinct residues mod
    # 2**owner_bits >= k+1, so a free residue always exists.
    empties = np.nonzero(slot_owner < 0)[0]
    for w in empties:
        lo = max(0, w - k + 1)
        used = {b & tmask for b in range(lo, w + 1) if base_used[b]}
        rho = next(r for r in range(tmask + 1) if r not in used)
        comb[w] = rho << cm.owner_shift
    cm.comb = comb.astype(np.int32)

    dt = np.zeros(rows_d * 128, dtype=np.int64)
    for j, cs in enumerate(centers):
        dt[j * k : (j + 1) * k] = cm.pack_entry(comp[cs], mc, 0)
    cm.def_table = dt.astype(np.int32)

    # --- exhaustive build verification (vectorized, cheap) ----------------
    ss = np.repeat(np.arange(S, dtype=np.int64), k)
    cc = np.tile(np.arange(k, dtype=np.int64), S)
    nxt, cnt = cm.resolve_classes(ss, cc)
    assert (nxt == comp[ss, cc]).all(), "comb resolution mismatch"
    assert (cnt == mc[comp[ss, cc]]).all(), "comb count mismatch"
    return cm


@dataclass
class CombTables:
    """The tables of B15 and B17 on one device (``convert.comb_tables_from_jax``
    builds the same from the JAX engine's arrays)."""

    classmap: torch.Tensor  # int32 [256] byte -> class
    comb: torch.Tensor  # int32 [rows_c * 128] displaced exception entries
    def_table: torch.Tensor  # int32 [rows_d * 128] default rows
    k: int
    owner_bits: int
    root_base: int  # the root's base and default row: every scan starts there
    root_def: int

    def args(self) -> tuple:
        """The tables as the kernels' wrappers take them."""
        return (self.classmap, self.comb, self.def_table, self.k, self.owner_bits,
                self.root_base, self.root_def)

    @staticmethod
    def from_arrays(classmap, comb, def_table, k: int, owner_bits: int, root_base: int,
                    root_def: int, device) -> "CombTables":
        cm = np.zeros(256, dtype=np.int32)
        cm[: np.asarray(classmap).size] = np.asarray(classmap, dtype=np.int32).reshape(-1)

        def dev(x):
            return torch.from_numpy(np.array(x, dtype=np.int32).reshape(-1)).to(device)

        return CombTables(classmap=dev(cm), comb=dev(comb), def_table=dev(def_table), k=int(k),
                          owner_bits=int(owner_bits), root_base=int(root_base),
                          root_def=int(root_def))

    @staticmethod
    def from_machine(cm: CombMachine, device) -> "CombTables":
        return CombTables.from_arrays(cm.classmap, cm.comb, cm.def_table, cm.k, cm.owner_bits,
                                      int(cm.base[0]), int(cm.def_idx[0]), device)


@dataclass
class CombStickyTables(CombTables):
    """The B16 kernel's tables: the comb build of the minimized sticky view,
    and ``absorb``, the absorbing state's base (the final base of a stream
    that saw a match)."""

    absorb: int = 0
    #: The least warm-up over which B16's segments restart their scans: the
    #: machine's ``max_needle_bytes - 1`` (a composed IgnoreCase machine's
    #: ``max_needle_bytes`` is ``max_raw_match_bytes + 4``); the sticky view
    #: and its quotient read no further back than the machine.
    min_overlap: int = 0

    def check_overlap(self, overlap: int) -> None:
        """Raise ``ValueError`` when ``overlap``, the warm-up over which B16's
        segments restart from the root, is below the machine's
        ``max_needle_bytes - 1``: a segment would not be in the stream's state
        by its own range."""
        if overlap < self.min_overlap:
            raise ValueError(f"the staging's overlap {overlap} is below the sticky machine's "
                             f"max_needle_bytes - 1 ({self.min_overlap})")

    def sticky_args(self) -> tuple:
        """The tables as ``comb_contains`` takes them."""
        return (*self.args(), self.absorb)


class CombAcEngine(DenseAcEngine):
    """``DenseAcEngine`` over comb32 tables: counts through B15, containsAny
    through B16, match positions through B15 and B17, per-position states
    through B17.  ``max_rows`` and
    ``overlap`` are the dense engine's keywords; ``max_rows`` bounds both
    builds.

    Staging, stream plans and ``adopt_staged`` are the dense engine's.  Two
    table sets are built, as in the JAX engine: ``comb`` from the
    count-minimized machine, which B15 scans, and ``comb_full`` from the
    full machine, which B17 scans; building both here makes a machine whose
    full table does not fit fail at construction.  Raises ``CapacityError``
    when a build does not fit."""

    def __init__(self, machine: AcMachine, *, device="cuda", n_streams: int = 32768,
                 t_tile: int = 128, max_rows: int = MAX_ROWS, overlap: Optional[int] = None):
        self._init_streams(machine, device, n_streams, t_tile, max_rows, overlap)
        self.comb_full = build_comb(machine, max_rows)
        mmin = count_minimized(machine)
        self.comb = self.comb_full
        if mmin is not machine:
            try:
                self.comb = build_comb(mmin, max_rows)
            except CapacityError:
                pass
        self.tables = CombTables.from_machine(self.comb, self.device)
        self.full_tables = (self.tables if self.comb is self.comb_full
                            else CombTables.from_machine(self.comb_full, self.device))
        self._inv_base = torch.from_numpy(self.comb_full.inv_base).to(self.device)
        self._sticky: Optional[CombStickyTables] = None

    # -- counting: kernel B15 ------------------------------------------------

    def _kernel_args(self, st: StagedStreams) -> tuple:
        """B15's arguments, the plan's warm-up last: the kernel may cut the
        streams into segments that each warm up over it."""
        return (st.streams, st.warm, st.vend, *self.tables.args(), st.plan.overlap)

    def stream_counts(self, st: StagedStreams) -> torch.Tensor:
        """int32 [S] per-stream counts on the device (kernel B15)."""
        return comb_count(*self._kernel_args(st))

    def stream_counts_plain(self, st: StagedStreams) -> torch.Tensor:
        return comb_count_plain(*self._kernel_args(st))

    # -- containsAny: the sticky scan (kernel B16) --------------------------

    def sticky_tables(self) -> CombStickyTables:
        """The sticky tables on this engine's device, built at first use:
        the comb build of the minimized sticky view of the count-minimized
        machine, given ``MAX_ROWS`` rows (the caller's budget sized the
        count tables).  Raises ``CapacityError`` when it does not fit."""
        if self._sticky is None:
            sv = minimize_sticky(_StickyView(count_minimized(self.machine)))
            cm = build_comb(sv, MAX_ROWS)
            t = CombTables.from_machine(cm, self.device)
            self._sticky = CombStickyTables(**t.__dict__, absorb=int(cm.base[sv.absorb]),
                                            min_overlap=max(0, self.machine.max_needle_bytes - 1))
        return self._sticky

    def sticky_args(self, st: StagedStreams) -> tuple:
        """Arguments of ``comb_contains`` (or its plain version), the plan's
        warm-up last: the kernel may cut the streams into segments that each
        warm up over it.  Raises ``ValueError`` when that warm-up is too
        short for the machine."""
        t = self.sticky_tables()
        t.check_overlap(st.plan.overlap)
        return (st.streams, st.vend, *t.sticky_args(), st.plan.overlap)

    def contains_staged(self, st: StagedStreams) -> bool:
        """Whether some live stream ended on the absorbing base of one sticky
        scan (B16)."""
        return self._any_absorbed(comb_contains(*self.sticky_args(st)), st.live_np)

    def contains_staged_early(self, st: StagedStreams, n_segments=None) -> bool:
        """Comb32 keeps the one-shot scan, as in the JAX package."""
        return self.contains_staged(st)

    # -- states, allMatches and containsAll: the packed states (kernel B17) --

    def bits_args(self, st: StagedStreams) -> tuple:
        """Comb32 has no hit-bitmap step, as in the JAX package."""
        raise NotImplementedError("comb32 has no hit-bitmap step: its extraction runs B15 and B17")

    def states_args(self, st: StagedStreams) -> tuple:
        """Arguments of ``comb_states`` (or its plain version): the full
        machine's tables, then the staging's overlap (at least this machine's:
        a grouped engine's groups take the full set's)."""
        return (st.streams, *self.full_tables.args(), st.plan.overlap)

    def packed_states(self, st: StagedStreams) -> torch.Tensor:
        """int32 [T, S] on the device: the full machine's packed entry of
        every step (B17)."""
        return comb_states(*self.states_args(st))

    #: The lowest bit of a packed entry's count field.
    count_shift = COUNT_SHIFT

    def _pk_states(self, pk: torch.Tensor) -> torch.Tensor:
        """States of the full machine's entries: its inverse base table."""
        return self._inv_base[pk.long() & BASE_MASK]

    def match_positions_staged(self, st: StagedStreams) -> Tuple[np.ndarray, np.ndarray]:
        """(end positions ascending, entered states) of every match, int64:
        always through the packed states (B15, then B17 where it counts
        matches), as comb32 has no bitmap step."""
        return self.match_positions_packed(st)


def plan_pallas(machine, max_rows: int = MAX_ROWS):
    """The JAX package's cheapest single-pass representation for
    ``machine``: ``("dense" | "comb" | "comb16", gather_cost)``, the cost
    being the TPU's table gathers per byte; raises :class:`CapacityError`
    when nothing fits ``max_rows`` rows.  Dense wins ties.

    Each representation is costed on the machine its engine scans: the comb
    engines on the count-minimized quotient, the dense engine on the full
    machine.  The port does not dispatch by it (see the module docstring);
    ``partition_adaptive`` sizes its groups by it."""
    from .comb16_scan import comb16_structure_cost  # comb16_scan imports this module

    options = []
    try:
        options.append(("dense", CompressedMachine.from_machine(machine, max_rows).rows))
    except CapacityError:
        pass
    if options and options[0][1] <= 2:
        # No comb representation can beat a <=2-row dense table (comb32
        # needs >= 2 gathers, comb16 >= 4): skip the quotient refinement.
        return options[0]
    mmin = count_minimized(machine)
    if (
        mmin.delta.shape[0] < (1 << BASE_BITS) - 64
        and int(np.asarray(mmin.match_count).max(initial=0)) <= MAX_COUNT
    ):
        try:
            rt, _, _ = comb_structure_cost(mmin, max_rows=max_rows)
            if rt <= max_rows:
                options.append(("comb", rt))
        except CapacityError:
            pass
    try:
        g16, _ = comb16_structure_cost(mmin)
        if g16 <= max_rows:
            options.append(("comb16", g16))
    except CapacityError:
        pass
    if not options:
        raise CapacityError(
            f"automaton ({machine.delta.shape[0]} states) fits neither dense "
            f"nor comb within {max_rows} rows"
        )
    # Stable preference on ties: dense < comb16 < comb.
    rank = {"dense": 0, "comb16": 1, "comb": 2}
    return min(options, key=lambda o: (o[1], rank[o[0]]))


def bitap_word_budget(gcost) -> int:
    """The JAX package's bitap register budget for a set whose cheapest
    single-pass table costs ``gcost`` TPU gathers per byte (None: nothing
    fits): 0.9 gcost words, at least 2 and at most 8.  The law was measured
    on the TPU; the sharded engine keeps it so that it takes the JAX
    engine's per-shard steps (ROADMAP item 7 re-derives it)."""
    return 8 if gcost is None else max(2, min(8, 9 * int(gcost) // 10))


def plan_bitap_auto(machine: AcMachine, max_rows: int = MAX_ROWS) -> Optional[BitapLayout]:
    """The JAX package's ``plan_bitap_auto``: a bitap layout under
    :func:`bitap_word_budget`, the byte-class one for a composed IgnoreCase
    machine, or None where none fits (a standalone trap register counting
    as one more word)."""
    try:
        _, gcost = plan_pallas(machine, max_rows)
    except CapacityError:
        gcost = None
    budget = bitap_word_budget(gcost)
    lay = plan_bitap(machine, max_words=budget)
    if lay is None and machine.composed_ci:
        lay = plan_bitap_ci(machine, max_words=budget)
    if lay is not None and lay.trap is not None and lay.n_words + 1 > max(2, budget):
        lay = None
    return lay


def make_engine(machine: AcMachine, device="cuda", *, max_rows: int = MAX_ROWS,
                overlap: Optional[int] = None, **kw):
    """The single-pass engine for ``machine``: ``BitapAcEngine`` when
    ``plan_bitap`` fits ``BITAP_MAX_WORDS`` words, or, for a composed
    IgnoreCase machine, ``plan_bitap_ci`` does (a standalone trap register
    counting as one more word, by the JAX rule of ``plan_bitap_auto``),
    else ``DenseAcEngine`` when its table fits ``max_rows`` rows, else
    ``Comb16AcEngine``, else ``CombAcEngine``.  ``max_rows``, ``overlap``
    and ``kw`` (``n_streams``, ``t_tile``) go to the engine.  Never builds
    the grouped engine (which calls this per group); raises
    ``CapacityError`` when nothing single-pass fits, and
    ``engine.MatchEngine`` then builds ``ops.grouped.GroupedAcEngine``."""
    from .comb16_scan import Comb16AcEngine  # comb16_scan imports this module

    kw = dict(kw, device=device, max_rows=max_rows, overlap=overlap)
    lay = plan_bitap(machine, max_words=BITAP_MAX_WORDS)
    if lay is None and machine.composed_ci:
        lay = plan_bitap_ci(machine, max_words=BITAP_MAX_WORDS)
        if lay is not None and lay.trap is not None and lay.n_words + 1 > BITAP_MAX_WORDS:
            lay = None  # the trap register is one word more than the budget
    if lay is not None:
        return BitapAcEngine(machine, layout=lay, **kw)
    try:
        return DenseAcEngine(machine, **kw)
    except CapacityError:
        pass
    try:
        # The JAX package's verdict on whether a comb table can hold the
        # machine in one pass: where its estimate says none does, it groups
        # the needles without trying a build, and so does the port.
        plan_pallas(machine, max_rows)
        try:
            return Comb16AcEngine(machine, **kw)
        except CapacityError:
            return CombAcEngine(machine, **kw)
    except CapacityError as e:
        raise CapacityError(
            f"{e}; no single-pass engine holds this automaton: the grouped engine "
            "(ops.grouped.GroupedAcEngine) takes such needle sets"
        ) from e


__all__ = [
    "BITAP_MAX_WORDS",
    "CombAcEngine",
    "CombMachine",
    "CombStickyTables",
    "CombTables",
    "build_comb",
    "comb_structure_cost",
    "bitap_word_budget",
    "make_engine",
    "plan_bitap_auto",
    "plan_pallas",
]
