"""16-bit three-tier comb engine over the hand-written CUDA kernels B8, B10,
B12 and B13: the mid-tier of needle sets too large for the dense table.

Counterpart of ``alfred_margaret_tpu/ops/comb16_scan.py``: ``Comb16Machine``,
``_unpack16``, ``_pack16``, ``MAX_COUNT16``, ``_field_split``,
``comb16_structure_cost``, ``_place``, ``_empty_residues``, ``build_comb16``,
``_build_with_fields``, ``build_comb16_uniform`` and ``build_sticky16_uniform``
are copied as numpy (that module imports ``jax``; ``tests/test_torch_comb16.py``
and ``tests/test_torch_grouped.py`` pin the copies field by field),
``Comb16AcEngine`` takes the place of ``Comb16PallasAcEngine``, and
``Comb16GroupTables`` holds the uniform builds' stacked tables for the
grouped kernels B9 and B11 (``ops/grouped.py``).

A DFA-ized Aho-Corasick row is the row of its failure state off trie edges,
and popular failure targets ("centers") are near-copies of the root row, so
a transition resolves in three tiers of 16-bit entries ``(count:CB |
owner:OB | base:BB)``:

    delta(s, c) = comb[base(s) + c]   if its owner residue is s's  (state vs center)
                | aux[cbase + c]      if its owner residue is the center's
                                      (cbase = segtable[base(s) >> (BB - 7)])
                | root_row[c]         (center vs root)

and a state is carried as its base.  Counts of 2 and more ride in base
ranges: ``count = count_bit + sum(base >= r for r in count_ranges)``.  The
count, contains and hit-bitmap kernels run on tables of the count-minimized
machine (``models/minimize.py``); match extraction replays the full machine
on the host, as the dense engine does, and the packed-states kernel B12
scans the tables of the full machine, whose bases name states.  The
TPU-only parts are left out: the compare chains that replace the root and
segment gathers (``AMT_C16_CHAINS``), the ``fold``/``wpairs`` class lookups,
the ``reps`` re-scan grid and the boundary-tile split.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..kernels.comb16 import comb16_contains, comb16_count, comb16_count_plain, comb16_states
from ..models.ac import AcMachine
from ..models.minimize import count_minimized, minimize_sticky
from .comb_scan import _center_candidates, _choose_classes, _mism_matrix
from .filter_scan import attach_filter, filter_contains
from .pallas_scan import MAX_ROWS, CapacityError, DenseAcEngine, StagedStreams, _StickyView


@dataclass
class Comb16Machine:
    """16-bit three-tier comb arrays (host side)."""

    classmap: np.ndarray  # int32 [256] byte -> class
    comb: np.ndarray  # int32 [rows_c * 128] packed 16-bit entry pairs
    aux: np.ndarray  # int32 [rows_a * 128] packed center-exception pairs
    root_row: np.ndarray  # int32 [128] root row, one DIRECT entry per lane
    #                       (k <= 96 entries; no 16-bit extraction needed)
    segtable: np.ndarray  # int32 [128] seg -> aux base of owning center
    base: np.ndarray  # int32 [n_states] unique in-range base per state
    cbase: np.ndarray  # int32 [D] aux base per center
    def_idx: np.ndarray  # int32 [n_states]
    inv_base: np.ndarray  # int32 [2^BB] base -> state (-1 empty)
    n_states: int
    k: int
    D: int
    rows_c: int
    rows_a: int
    CB: int
    OB: int
    BB: int
    n_exceptions: int
    #: Base-range thresholds for counts >= 2: count = count_bit +
    #: sum(base >= r for r in count_ranges).  States are placed in
    #: count-ascending arenas so these are well defined.
    count_ranges: tuple = ()

    @property
    def base_mask(self) -> int:
        return (1 << self.BB) - 1

    @property
    def owner_mask(self) -> int:
        return (1 << self.OB) - 1

    @property
    def count_shift(self) -> int:
        return 16 - self.CB  # count field sits at the top of the entry

    @property
    def rows_total(self) -> int:
        """Gathers per byte (the performance currency): comb rows + segtable
        + aux rows + root row."""
        return self.rows_c + self.rows_a + 2

    def pack_entry(self, target: np.ndarray, mc: np.ndarray, owner_res) -> np.ndarray:
        e = np.asarray(owner_res, dtype=np.int64) << self.BB
        e = e | self.base[target].astype(np.int64)
        if self.CB:
            bit = np.minimum(mc[target].astype(np.int64), 1)
            e = e | (bit << self.count_shift)
        return e

    def count_of_base(self, base) -> np.ndarray:
        """Count of the state with this base, above the count bit (host
        mirror of the kernel's base-range terms)."""
        extra = np.zeros_like(np.asarray(base, dtype=np.int64))
        for r in self.count_ranges:
            extra += np.asarray(base, dtype=np.int64) >= r
        return extra

    # -- host-side one-step resolution (oracle for build verification) -----

    def resolve_classes(self, states: np.ndarray, classes: np.ndarray):
        """(next_state, count) per element, emulating the kernel exactly."""
        b = self.base[states].astype(np.int64)
        w1 = b + classes
        e1 = _unpack16(self.comb, w1)
        hit1 = ((e1 >> self.BB) & self.owner_mask) == (b & self.owner_mask)
        seg = b >> (self.BB - 7)
        cb = self.segtable[seg].astype(np.int64)
        w2 = cb + classes
        e2 = _unpack16(self.aux, w2)
        hit2 = ((e2 >> self.BB) & self.owner_mask) == (cb & self.owner_mask)
        er = self.root_row[classes].astype(np.int64)  # 32-bit direct entries
        e = np.where(hit1, e1, np.where(hit2, e2, er))
        nb = e & self.base_mask
        nxt = self.inv_base[nb]
        if self.CB:
            cnt = ((e >> self.count_shift) & 1) + self.count_of_base(nb)
        else:
            cnt = np.zeros_like(e)
        return nxt, cnt


def _unpack16(words: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Host-side 16-bit entry extraction from packed int32 words."""
    word = words[np.asarray(w, dtype=np.int64) >> 1].astype(np.int64) & 0xFFFFFFFF
    return np.where((w & 1) == 1, word >> 16, word) & 0xFFFF


def _pack16(entries: np.ndarray, n_words: int) -> np.ndarray:
    """Pack an int64 entry array (values < 2^16) into int32 word pairs."""
    flat = np.zeros(n_words * 2, dtype=np.int64)
    flat[: len(entries)] = entries
    out = flat[0::2] | (flat[1::2] << 16)
    return out.astype(np.uint32).view(np.int32)


#: Highest per-state match count comb16 supports.  Counts above 1 don't fit
#: the single entry bit; they are encoded in *base ranges* instead — states
#: with match_count >= c get bases above the segment-aligned boundary R_c,
#: and the kernel adds ``(base >= R_c)`` per extra level (ALU-free on the
#: gather-bound loop).
MAX_COUNT16 = 7


def _field_split(max_count: int, n_states: int):
    """Candidate (CB, OB, BB) ladders, cheapest-space first.  CB is 1 bit at
    most: higher counts ride in base ranges (see ``MAX_COUNT16``)."""
    if max_count > MAX_COUNT16:
        raise CapacityError(f"match count {max_count} exceeds comb16 range encoding")
    CB = 0 if max_count == 0 else 1
    out = []
    for OB in (5, 4):
        BB = 16 - CB - OB
        if BB < 8 or n_states + 8 > (1 << BB):
            continue
        out.append((CB, OB, BB))
    if not out:
        raise CapacityError(f"{n_states} states exceed comb16 base space")
    return out


def comb16_structure_cost(machine, d_candidates=(16, 32, 64, 128)):
    """Estimate (gathers_total, D) without placement — for the grouped
    partitioner's budget search.  Raises CapacityError on hard gates."""
    comp, _ = _choose_classes(machine.delta)
    S, k = comp.shape
    if k > 96:
        raise CapacityError(f"k={k} too wide for comb16 probe windows")
    mc = np.asarray(machine.match_count, dtype=np.int64)
    splits = _field_split(int(mc.max(initial=0)), S)
    cand = _center_candidates(machine, S, max(d_candidates))
    run_min = np.minimum.accumulate(_mism_matrix(comp, cand), axis=1)
    best = None
    for CB, OB, BB in splits:
        for D in d_candidates:
            D = min(D, len(cand))
            exc = int(run_min[:, D - 1].sum(dtype=np.int64))
            # Base density: windows of k positions hold < 2^OB bases (the
            # empty-slot residue guarantee), so usable density caps at
            # (2^OB - 1)/k; slot density via first-fit ~0.8.
            dens = min(0.8, ((1 << OB) - 1) / k)
            need = max(int(exc / 0.8), int(S / dens)) + k
            if need > (1 << BB):
                continue
            rows_c = max(1, -(-need // 256))
            cexc = int((comp[cand[:D]] != comp[0][None, :]).sum())
            rows_a = max(1, -(-int(cexc / 0.8 + D * 2 + k) // 256))
            g = rows_c + rows_a + 2
            if best is None or g < best[0]:
                best = (g, D)
        if best is not None:
            break  # prefer the wider-owner split when it fits at all
    if best is None:
        raise CapacityError("comb16: no D fits the base space")
    return best


def _place(
    space: int,
    k: int,
    OB: int,
    seg_size: int,
    owners: List[tuple],
    max_pos: int,
):
    """First-fit placement of ``(group, exception-classes, count_class)``
    owners into a shared slot/base space with exact truncated-owner-residue
    guarantees.  Owners must be sorted by count_class ascending; each
    count-class arena starts above every lower arena's bases, yielding the
    range boundaries for the base-range count encoding.

    Returns (base_positions, high_water, seg_owner, boundaries) where
    ``boundaries[c]`` is the first base position of count-class c (compare
    threshold).  Raises CapacityError when a base cannot be placed.

    Invariants enforced (soundness of the OB-bit owner check):
      * slots free; base positions unique;
      * no two bases within distance < k share a residue mod 2^OB
        (only such pairs can probe a common slot);
      * every k-window keeps < 2^OB bases, so empty slots always have a
        spare miss residue.
    """
    omask = (1 << OB) - 1
    occ = np.zeros(space + k, dtype=bool)
    is_base = np.zeros(space, dtype=bool)
    banned = np.zeros((1 << OB, space), dtype=bool)  # residue r banned at pos
    wcount = np.zeros(space + k, dtype=np.int16)
    n_segs = -(-space // seg_size)
    seg_owner = np.full(n_segs, -1, dtype=np.int64)
    positions = np.arange(space)
    bases = np.empty(len(owners), dtype=np.int64)
    high = 0
    max_base = -1
    cur_class = 0
    min_pos = 0
    boundaries: dict = {}

    for i, (grp, exc, cclass) in enumerate(owners):
        if cclass != cur_class:
            if cclass < cur_class:
                raise ValueError("owners must be sorted by count_class")
            min_pos = max_base + 1
            boundaries[cclass] = min_pos
            cur_class = cclass
        # Candidate mask: in a segment owned by grp (or ownable), above the
        # arena floor, slot positions free, not already a base, residue not
        # banned by a same-residue base within k.
        segs_ok = (seg_owner == grp) | (seg_owner == -1)
        pos_ok = segs_ok[positions // seg_size]
        bad = is_base.copy()
        for c in exc:
            bad |= occ[c : c + space]
        cand_mask = pos_ok & ~bad
        cand_mask &= ~banned[positions & omask, positions]
        if min_pos:
            cand_mask[:min_pos] = False
        lim = max_pos - (int(exc[-1]) if len(exc) else 0)
        cand = np.nonzero(cand_mask[:lim])[0]
        placed = False
        for b in cand:
            b = int(b)
            if wcount[b : b + k].max(initial=0) >= omask:  # keep < 2^OB per window
                continue
            bases[i] = b
            is_base[b] = True
            occ[b + exc] = True
            # Ban this residue near b for future bases (distance < k).
            lo = max(0, b - k + 1)
            pb = np.arange(lo, min(space, b + k))
            banned[b & omask, pb[(pb & omask) == (b & omask)]] = True
            wcount[b : b + k] += 1
            if seg_owner[b // seg_size] == -1:
                seg_owner[b // seg_size] = grp
            high = max(high, b + (int(exc[-1]) + 1 if len(exc) else 1))
            max_base = max(max_base, b)
            placed = True
            break
        if not placed:
            raise CapacityError("comb16 placement overflow")
    return bases, high, seg_owner, boundaries


def _empty_residues(entries_len: int, k: int, OB: int, bases: np.ndarray):
    """For each slot, a residue distinct from every base that can probe it
    (placement keeps < 2^OB bases per window, so one always exists)."""
    omask = (1 << OB) - 1
    base_res = np.full(entries_len + k, -1, dtype=np.int64)
    base_res[bases] = bases & omask
    out = np.zeros(entries_len, dtype=np.int64)
    for w in range(entries_len):
        lo = max(0, w - k + 1)
        used = set(int(r) for r in base_res[lo : w + 1] if r >= 0)
        out[w] = next(r for r in range(omask + 1) if r not in used)
    return out


def build_comb16(
    machine, max_rows_total: int = MAX_ROWS, split: Optional[tuple] = None
) -> Comb16Machine:
    """Build a :class:`Comb16Machine`; raises :class:`CapacityError` when the
    machine cannot fit (callers fall back to comb32 / dense / grouped).

    ``split`` forces one ``(CB, OB, BB)`` field split instead of the ladder —
    the distributed engine uses this to build UNIFORM table sets across
    needle groups so one kernel serves every shard."""
    comp, classmap = _choose_classes(machine.delta)
    S, k = comp.shape
    if k > 96:
        raise CapacityError(f"k={k} too wide for comb16 probe windows")
    mc = np.asarray(machine.match_count, dtype=np.int64)
    if split is not None:
        CB, OB, BB = split
        if CB + OB + BB != 16 or BB < 8 or S + 8 > (1 << BB):
            raise CapacityError(f"forced split {split} cannot hold {S} states")
        if int(mc.max(initial=0)) > MAX_COUNT16:
            raise CapacityError("match count exceeds comb16 range encoding")
        splits = [split]
    else:
        splits = _field_split(int(mc.max(initial=0)), S)

    _, D = comb16_structure_cost(machine)
    centers = _center_candidates(machine, S, D)
    D = len(centers)
    mm = _mism_matrix(comp, centers)
    def_of = mm.argmin(1).astype(np.int32)
    exc_cnt = mm.min(1).astype(np.int64)
    total_exc = int(exc_cnt.sum())

    last_err = None
    for CB, OB, BB in splits:
        try:
            return _build_with_fields(
                machine, comp, classmap, centers, def_of, exc_cnt, total_exc,
                mc, S, k, D, CB, OB, BB, max_rows_total,
            )
        except CapacityError as e:
            last_err = e
    raise last_err


def _build_with_fields(
    machine, comp, classmap, centers, def_of, exc_cnt, total_exc,
    mc, S, k, D, CB, OB, BB, max_rows_total,
):
    space = 1 << BB
    seg_size = space // 128  # 128-entry segtable, one gather

    # --- main comb: state-vs-center exceptions ----------------------------
    # Count-ascending arenas (count-class = max(0, mc-1)) give the
    # base-range count encoding; within an arena, big-exception owners
    # first (first-fit quality).
    cclass = np.maximum(0, mc - 1)
    order = np.lexsort((np.arange(S), -exc_cnt, cclass))
    owners = []
    exc_classes: List[np.ndarray] = [None] * S
    for s in order:
        s = int(s)
        e = np.nonzero(comp[s] != comp[centers[def_of[s]]])[0]
        exc_classes[s] = e
        owners.append((int(def_of[s]), e, int(cclass[s])))
    max_pos = min(space, max_rows_total * 256) - k
    bases_o, high, seg_owner, _bnds = _place(space, k, OB, seg_size, owners, max_pos)
    base = np.empty(S, dtype=np.int32)
    base[order] = bases_o
    # Rows must cover every probe window (base + k), not just owned slots —
    # the top base's probes can extend past the occupancy high-water.
    rows_c = max(1, -(-max(high, int(base.max(initial=0)) + k) // 256))
    if rows_c + 3 > max_rows_total:
        raise CapacityError(f"comb16 needs {rows_c}+ rows > budget")
    m_pad = rows_c * 256
    # Range thresholds: R_c = min base among states with count >= c (well
    # defined by arena ordering; class gaps inherit the next boundary).
    max_mc = int(mc.max(initial=0))
    count_ranges = []
    for c in range(2, max_mc + 1):
        sel = base[mc >= c]
        count_ranges.append(int(sel.min()))
    count_ranges = tuple(count_ranges)

    # --- aux: center-vs-root exceptions -----------------------------------
    aux_space = 1 << 10
    aux_exc: List[np.ndarray] = []
    for j in range(D):
        aux_exc.append(np.nonzero(comp[centers[j]] != comp[0])[0])
    # Place big centers first (same first-fit quality argument).  All aux
    # owners share one placement group: cbase is found via the segment
    # table, so aux bases have no segment-ownership constraint.
    aorder = sorted(range(D), key=lambda j: -len(aux_exc[j]))
    cb_o, ahigh, _, _ = _place(
        aux_space, k, OB, aux_space, [(0, aux_exc[j], 0) for j in aorder],
        aux_space - k,
    )
    cbase = np.empty(D, dtype=np.int32)
    cbase[aorder] = cb_o
    rows_a = max(1, -(-ahigh // 256))
    a_pad = rows_a * 256
    if int(cbase.max(initial=0)) + k > a_pad:
        # A probe window (cbase + k) may extend past the padded rows — the
        # kernel would read garbage beyond the array (and the build
        # verification below would IndexError instead of falling back).
        rows_a = -(-(int(cbase.max(initial=0)) + k) // 256)
        a_pad = rows_a * 256
    if rows_c + rows_a + 2 > max_rows_total:
        # Exact budget check now that both row counts are final (the
        # rows_c-side early check assumed rows_a == 1).
        raise CapacityError(
            f"comb16 needs {rows_c}+{rows_a}+2 gathers > {max_rows_total} budget"
        )

    mach = Comb16Machine(
        classmap=classmap,
        comb=np.zeros(rows_c * 128, dtype=np.int32),
        aux=np.zeros(rows_a * 128, dtype=np.int32),
        root_row=np.zeros(128, dtype=np.int32),
        segtable=np.zeros(128, dtype=np.int32),
        base=base,
        cbase=cbase,
        def_idx=def_of,
        inv_base=np.full(space, -1, dtype=np.int32),
        n_states=S,
        k=k,
        D=D,
        rows_c=rows_c,
        rows_a=rows_a,
        CB=CB,
        OB=OB,
        BB=BB,
        n_exceptions=total_exc,
        count_ranges=count_ranges,
    )
    mach.inv_base[base] = np.arange(S, dtype=np.int32)
    omask = mach.owner_mask

    # --- fill main comb -----------------------------------------------------
    entries = np.zeros(m_pad, dtype=np.int64)
    slot_owned = np.zeros(m_pad, dtype=bool)
    for s in range(S):
        e = exc_classes[s]
        if len(e) == 0:
            continue
        w = base[s] + e
        entries[w] = mach.pack_entry(comp[s, e], mc, base[s] & omask)
        slot_owned[w] = True
    res = _empty_residues(m_pad, k, OB, np.asarray(base, dtype=np.int64))
    emptyw = np.nonzero(~slot_owned)[0]
    entries[emptyw] = res[emptyw] << BB
    mach.comb = _pack16(entries, rows_c * 128)

    # --- fill aux ------------------------------------------------------------
    a_entries = np.zeros(a_pad, dtype=np.int64)
    a_owned = np.zeros(a_pad, dtype=bool)
    for j in range(D):
        e = aux_exc[j]
        if len(e) == 0:
            continue
        w = cbase[j] + e
        a_entries[w] = mach.pack_entry(comp[centers[j], e], mc, cbase[j] & omask)
        a_owned[w] = True
    ares = _empty_residues(a_pad, k, OB, np.asarray(cbase, dtype=np.int64))
    aemptyw = np.nonzero(~a_owned)[0]
    a_entries[aemptyw] = ares[aemptyw] << BB
    mach.aux = _pack16(a_entries, rows_a * 128)

    # --- root row + segtable -------------------------------------------------
    if k > 128:
        raise CapacityError("root row exceeds one physical row")
    rr = np.zeros(128, dtype=np.int64)
    rr[:k] = mach.pack_entry(comp[0], mc, 0)
    mach.root_row = rr.astype(np.int32)
    seg = np.zeros(128, dtype=np.int32)
    for g in range(128):
        if g < len(seg_owner) and seg_owner[g] >= 0:
            seg[g] = cbase[seg_owner[g]]
        else:
            # Unowned segment: point at the root center's aux base if root is
            # a center (it always is, index 0 of _center_candidates).
            seg[g] = cbase[0]
    mach.segtable = seg

    # --- exhaustive build verification (vectorized) --------------------------
    ss = np.repeat(np.arange(S, dtype=np.int64), k)
    cc = np.tile(np.arange(k, dtype=np.int64), S)
    nxt, cnt = mach.resolve_classes(ss, cc)
    if not (nxt == comp[ss, cc]).all():
        raise CapacityError("comb16 resolution mismatch (build bug)")
    if CB and not (cnt == mc[comp[ss, cc]]).all():
        raise CapacityError("comb16 count mismatch (build bug)")
    return mach


@dataclass
class Comb16Tables:
    """The B8 kernel's tables (and B13's comb16 step) on one device.

    ``convert.comb16_tables_from_jax`` builds the same from the JAX engine's
    arrays.  ``ranges`` holds the count ranges padded to ``MAX_COUNT16 - 1``
    entries with ``2**BB``, which no base reaches."""

    classmap: torch.Tensor  # int32 [256] byte -> class
    comb: torch.Tensor  # int32 [rows_c * 128] 16-bit entry pairs, low half first
    aux: torch.Tensor  # int32 [rows_a * 128]
    root_row: torch.Tensor  # int32 [128] direct entries
    segtable: torch.Tensor  # int32 [128] segment -> aux base of its center
    ranges: torch.Tensor  # int32 [MAX_COUNT16 - 1]
    BB: int
    owner_mask: int
    CB: int
    root_cb: int  # the root's base: every scan starts there

    def args(self) -> tuple:
        """The tables as the kernels' wrappers take them."""
        return (self.classmap, self.comb, self.aux, self.root_row, self.segtable, self.ranges,
                self.BB, self.owner_mask, self.CB, self.root_cb)

    @staticmethod
    def from_arrays(classmap, comb, aux, root_row, segtable, count_ranges, BB: int, OB: int,
                    CB: int, root_cb: int, device, bases=(), cbases=(), k: int = 0) -> "Comb16Tables":
        """Tables from host arrays.  The kernels index the flat tables with
        ``base + class`` and ``cbase + class`` unclamped (the TPU kernel's
        lanes wrap mod 128 instead), so every probe window must lie inside
        its table: raises ``CapacityError`` when ``max(bases) + k`` or
        ``max(cbases) + k`` passes the end."""
        comb = np.asarray(comb, dtype=np.int32).reshape(-1)
        aux = np.asarray(aux, dtype=np.int32).reshape(-1)
        for name, b, tab in (("comb", bases, comb), ("aux", cbases, aux)):
            if len(b) and int(np.max(b)) + k > 2 * tab.size:
                raise CapacityError(
                    f"comb16 {name} probe window {int(np.max(b))} + {k} passes its "
                    f"{2 * tab.size} entries"
                )
        if len(count_ranges) > MAX_COUNT16 - 1:
            raise CapacityError(f"{len(count_ranges)} count ranges exceed MAX_COUNT16")
        cm = np.zeros(256, dtype=np.int32)
        cm[: len(classmap)] = np.asarray(classmap, dtype=np.int32).reshape(-1)
        ranges = np.full(MAX_COUNT16 - 1, 1 << BB, dtype=np.int32)
        ranges[: len(count_ranges)] = count_ranges

        def dev(x):
            return torch.from_numpy(np.array(x, dtype=np.int32)).to(device)  # a writable copy

        return Comb16Tables(
            classmap=dev(cm), comb=dev(comb), aux=dev(aux),
            root_row=dev(np.asarray(root_row).reshape(-1)),
            segtable=dev(np.asarray(segtable).reshape(-1)),
            ranges=dev(ranges), BB=int(BB), owner_mask=(1 << OB) - 1, CB=int(CB),
            root_cb=int(root_cb),
        )

    @staticmethod
    def from_machine(c16: Comb16Machine, device) -> "Comb16Tables":
        return Comb16Tables.from_arrays(
            c16.classmap, c16.comb, c16.aux, c16.root_row, c16.segtable, c16.count_ranges,
            c16.BB, c16.OB, c16.CB, int(c16.base[0]), device,
            bases=c16.base, cbases=c16.cbase, k=c16.k,
        )


@dataclass
class Comb16StickyTables(Comb16Tables):
    """The B10 kernel's tables: the comb16 build of the minimized sticky
    view, and ``absorb``, the absorbing state's base (the final base of a
    stream that saw a match).  B10 takes the root and absorbing bases as
    arguments, so no device scalar rides with the tables.  ``convert.comb16_tables_from_jax`` builds the
    same from the JAX engine's arrays."""

    absorb: int = 0

    def sticky_args(self) -> tuple:
        """The tables as ``comb16_contains`` takes them."""
        return (self.classmap, self.comb, self.aux, self.root_row, self.segtable,
                self.BB, self.owner_mask, self.root_cb, self.absorb)


def build_comb16_uniform(machines, max_rows_total: int = MAX_ROWS, split=None):
    """Comb16 table sets for a list of (needle-group) machines with one
    UNIFORM field split, stacked for the grouped kernels:

    Returns ``(c16s, stacked)`` where ``stacked`` is a dict of numpy arrays
    ``classmap [G,2,128]``, ``comb [G,rows_c,128]``, ``aux [G,rows_a,128]``,
    ``rootseg [G,2,128]``, ``gscal [G,1+n_ranges]`` (root base + count-range
    thresholds, padded with the 2^BB sentinel), plus the static consts.
    Zero row padding is safe: every group's probes stay inside its own
    padded rows (placement bounds ``base + k`` by its row count).

    ``split`` pins one ``(CB, OB, BB)`` instead of the ladder (callers that
    partitioned against a forced split, ``ops.grouped.partition_uniform16``,
    pass it).  Raises :class:`CapacityError` when no single split fits every
    group."""
    if split is not None:
        CB, OB, BB = split
        c16s = [build_comb16(m, max_rows_total, split=split) for m in machines]
    else:
        CB = 1 if any(int(np.asarray(m.match_count).max(initial=0)) > 0 for m in machines) else 0
        last = None
        for OB in (5, 4):
            BB = 16 - CB - OB
            try:
                c16s = [build_comb16(m, max_rows_total, split=(CB, OB, BB)) for m in machines]
                break
            except CapacityError as e:
                last = e
        else:
            raise last
    G = len(c16s)
    rows_c = max(c.rows_c for c in c16s)
    rows_a = max(c.rows_a for c in c16s)
    n_ranges = max(len(c.count_ranges) for c in c16s)
    sentinel = 1 << BB
    classmap = np.zeros((G, 2, 128), dtype=np.int32)
    comb = np.zeros((G, rows_c, 128), dtype=np.int32)
    aux = np.zeros((G, rows_a, 128), dtype=np.int32)
    rootseg = np.zeros((G, 2, 128), dtype=np.int32)
    gscal = np.full((G, 1 + max(1, n_ranges)), sentinel, dtype=np.int32)
    for g, c in enumerate(c16s):
        cm256 = np.zeros(256, dtype=np.int32)
        cm256[: len(c.classmap)] = c.classmap
        classmap[g] = cm256.reshape(2, 128)
        comb[g, : c.rows_c] = c.comb.reshape(c.rows_c, 128)
        aux[g, : c.rows_a] = c.aux.reshape(c.rows_a, 128)
        rootseg[g] = np.stack([c.root_row, c.segtable])
        gscal[g, 0] = int(c.base[0])
        for ri, thr in enumerate(c.count_ranges):
            gscal[g, 1 + ri] = int(thr)
    consts = dict(
        CB=CB, OB=OB, BB=BB, rows_c=rows_c, rows_a=rows_a,
        n_ranges=max(1, n_ranges) if CB else 0,
        owner_mask=(1 << OB) - 1, count_shift=16 - CB, seg_shift=BB - 7,
    )
    return c16s, dict(
        classmap=classmap, comb=comb, aux=aux, rootseg=rootseg, gscal=gscal,
        consts=consts,
    )


def build_sticky16_uniform(machines, max_rows_total: int = MAX_ROWS, split=None, views=None):
    """Uniform comb16 STICKY tables for a list of machines: each machine's
    absorbing view is count-quotiented, all views build with one shared
    field split, and ``gscal`` holds per-group ``(root base, absorb base)``
    rows.  ``views`` passes pre-minimized sticky views
    (``ops.grouped.partition_uniform16(view="sticky")`` built them); ``split``
    pins the field split it validated.  Returns ``(c16s, stacked)`` like
    :func:`build_comb16_uniform`; raises :class:`CapacityError` when no
    single split fits every view."""
    svs = (
        views
        if views is not None
        else [minimize_sticky(_StickyView(count_minimized(m))) for m in machines]
    )
    c16s, stacked = build_comb16_uniform(svs, max_rows_total, split=split)
    gscal2 = np.stack(
        [
            stacked["gscal"][:, 0],
            np.asarray([int(c.base[sv.absorb]) for sv, c in zip(svs, c16s)], dtype=np.int32),
        ],
        axis=1,
    ).astype(np.int32)
    stacked = dict(stacked, gscal=gscal2)
    return c16s, stacked


@dataclass
class Comb16GroupTables:
    """The tables of the grouped kernels B9 and B11 on one device: one comb16
    table set per needle group under one field split, stacked, each group's
    comb and aux padded with zero rows to the widest group's.

    ``gscal`` holds each group's scalars: for counting ``[G, 1 + n_ranges]``
    (its root base, then its count ranges padded with ``2**BB``), for the
    sticky scan (``sticky``) ``[G, 2]`` (its root base and its absorbing
    base); ``gscal_host`` holds the same rows as host ints, whence B11's
    one-group mode takes its bases as launch arguments.
    ``convert.comb16_group_tables_from_jax`` builds the same from the JAX
    engine's stacked arrays."""

    classmap: torch.Tensor  # int32 [G, 256] byte -> class
    comb: torch.Tensor  # int32 [G, rows_c * 128] 16-bit entry pairs, low half first
    aux: torch.Tensor  # int32 [G, rows_a * 128]
    root_row: torch.Tensor  # int32 [G, 128] direct entries
    segtable: torch.Tensor  # int32 [G, 128] segment -> aux base of its center
    gscal: torch.Tensor  # int32 [G, 1 + n_ranges] (count) or [G, 2] (sticky)
    gscal_host: tuple  # gscal's rows, tuples of ints
    BB: int
    owner_mask: int
    CB: int
    sticky: bool

    @property
    def n_groups(self) -> int:
        return int(self.classmap.shape[0])

    def group(self, g: int, device=None) -> "Comb16GroupTables":
        """Group ``g``'s tables alone (``G = 1``), on ``device`` (default:
        where these are): the sharded engine's per-shard tables."""

        def one(x):
            x = x[g : g + 1].contiguous()
            return x if device is None else x.to(device)

        return dataclasses.replace(
            self, classmap=one(self.classmap), comb=one(self.comb), aux=one(self.aux),
            root_row=one(self.root_row), segtable=one(self.segtable), gscal=one(self.gscal),
            gscal_host=self.gscal_host[g : g + 1])

    @staticmethod
    def from_stacked(stacked: dict, device, *, sticky: bool = False,
                     c16s=()) -> "Comb16GroupTables":
        """Tables from the stacked arrays of :func:`build_comb16_uniform` or
        :func:`build_sticky16_uniform`.  With the groups' builds ``c16s``, the
        probe windows of ``Comb16Tables.from_arrays`` are checked per group
        against its padded table; the root (and absorbing) bases are checked
        against the base space always.  Raises ``CapacityError``."""
        cst = stacked["consts"]
        classmap = np.asarray(stacked["classmap"], dtype=np.int32)
        comb = np.asarray(stacked["comb"], dtype=np.int32)
        aux = np.asarray(stacked["aux"], dtype=np.int32)
        rootseg = np.asarray(stacked["rootseg"], dtype=np.int32)
        gscal = np.asarray(stacked["gscal"], dtype=np.int32)
        G, BB = classmap.shape[0], int(cst["BB"])
        if G < 1 or rootseg.shape != (G, 2, 128) or gscal.shape[0] != G:
            raise ValueError("stacked group tables disagree on the group count")
        if sticky and gscal.shape[1] != 2:
            raise ValueError(f"sticky gscal must be [G, 2], got {gscal.shape}")
        if not sticky and gscal.shape[1] - 1 > MAX_COUNT16 - 1:
            raise CapacityError(f"{gscal.shape[1] - 1} count ranges exceed MAX_COUNT16")
        bases = gscal[:, :2] if sticky else gscal[:, :1]
        if (bases < 0).any() or (bases >= (1 << BB)).any():
            raise CapacityError(f"a group's root or absorbing base is outside {BB} bits")
        comb_entries, aux_entries = 2 * comb[0].size, 2 * aux[0].size
        for g, c in enumerate(c16s):
            for name, b, n in (("comb", c.base, comb_entries), ("aux", c.cbase, aux_entries)):
                if len(b) and int(np.max(b)) + c.k > n:
                    raise CapacityError(
                        f"group {g}: comb16 {name} probe window {int(np.max(b))} + {c.k} "
                        f"passes its {n} entries"
                    )

        def dev(x):
            return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32).copy()).to(device)

        return Comb16GroupTables(
            classmap=dev(classmap.reshape(G, 256)), comb=dev(comb.reshape(G, -1)),
            aux=dev(aux.reshape(G, -1)), root_row=dev(rootseg[:, 0]), segtable=dev(rootseg[:, 1]),
            gscal=dev(gscal), gscal_host=tuple(tuple(int(x) for x in row) for row in gscal),
            BB=BB, owner_mask=int(cst["owner_mask"]), CB=int(cst["CB"]),
            sticky=sticky,
        )


class Comb16AcEngine(DenseAcEngine):
    """``DenseAcEngine`` over comb16 tables: counts through B8, containsAny
    through the stride-2 screen (B14) and then B10, the hit bitmap through
    B6 with the comb16 step (B13), per-position states through B12.
    ``max_rows`` and ``overlap`` are the dense engine's keywords;
    ``max_rows`` bounds both builds.

    Staging, stream plans, ``adopt_staged``, the extraction routes and the
    ``final_states`` stitch are the dense engine's.  Two table sets are
    built, as in the JAX engine: ``c16`` from the count-minimized machine,
    which B8, B10 and B13 scan, and ``c16_full`` from the full machine, which
    B12 scans; building both here makes a machine whose full table does not
    fit fail at construction.  Raises ``CapacityError`` when a build does
    not fit."""

    def __init__(self, machine: AcMachine, *, device="cuda", n_streams: int = 32768,
                 t_tile: int = 128, max_rows: int = MAX_ROWS, overlap: Optional[int] = None):
        self._init_streams(machine, device, n_streams, t_tile, max_rows, overlap)
        self.c16_full = build_comb16(machine, max_rows)
        mmin = count_minimized(machine)
        self.c16 = self.c16_full
        if mmin is not machine:
            try:
                self.c16 = build_comb16(mmin, max_rows)
            except CapacityError:
                pass
        self.tables = Comb16Tables.from_machine(self.c16, self.device)
        self.full_tables = (self.tables if self.c16 is self.c16_full
                            else Comb16Tables.from_machine(self.c16_full, self.device))
        self._inv_base = torch.from_numpy(self.c16_full.inv_base).to(self.device)
        self._sticky: Optional[Comb16StickyTables] = None
        attach_filter(self, machine)

    # -- counting: kernel B8 -------------------------------------------------

    def _kernel_args(self, st: StagedStreams) -> tuple:
        """Arguments of ``comb16_count`` (or its plain version): the tables,
        then the plan's warm-up, over which the kernel's segments restart
        from the root."""
        return (st.streams, st.warm, st.vend, *self.tables.args(), st.plan.overlap)

    def stream_counts(self, st: StagedStreams) -> torch.Tensor:
        """int32 [S] per-stream counts on the device (kernel B8)."""
        return comb16_count(*self._kernel_args(st))

    def stream_counts_plain(self, st: StagedStreams) -> torch.Tensor:
        return comb16_count_plain(*self._kernel_args(st))

    # -- containsAny: the screen (B14), then the sticky scan (B10) ----------

    def sticky_tables(self) -> Comb16StickyTables:
        """The sticky tables on this engine's device, built at first use:
        the comb16 build of the minimized sticky view of the count-minimized
        machine (sticky redirection depends only on ``match_count > 0``,
        which the count quotient keeps).  Raises ``CapacityError`` when the
        view does not fit ``MAX_ROWS`` rows."""
        if self._sticky is None:
            sv = minimize_sticky(_StickyView(count_minimized(self.machine)))
            c16 = build_comb16(sv, MAX_ROWS)
            t = Comb16Tables.from_machine(c16, self.device)
            self._sticky = Comb16StickyTables(**t.__dict__, absorb=int(c16.base[sv.absorb]))
        return self._sticky

    def sticky_args(self, st: StagedStreams) -> tuple:
        """Arguments of ``comb16_contains`` (or its plain version), the plan's
        warm-up last: the kernel may cut the streams into segments that each
        warm up over it."""
        return (st.streams, st.vend, *self.sticky_tables().sticky_args(), st.plan.overlap)

    def contains_staged(self, st: StagedStreams) -> bool:
        """The screen's answer where it has one (an exact short-needle hit,
        or no candidate anywhere), else whether some live stream ended on the
        absorbing base of one sticky scan (B10)."""
        got = filter_contains(self, st)
        if got is not None:
            return got
        return self._any_absorbed(comb16_contains(*self.sticky_args(st)), st.live_np)

    def contains_staged_early(self, st: StagedStreams, n_segments=None) -> bool:
        """Comb16 keeps the one-shot scan, as in the JAX package."""
        return self.contains_staged(st)

    # -- allMatches and containsAll: the hit bitmap (B6 with the comb16 step) --

    def bits_args(self, st: StagedStreams) -> tuple:
        """Arguments of ``matchbits``: the comb16 step (B13) on the
        count-minimized tables."""
        return (st.streams, st.warm, st.vend, "comb16", *self.tables.args())

    # -- per-position states: kernel B12 on the full machine's tables ---------

    def states_args(self, st: StagedStreams) -> tuple:
        """Arguments of ``comb16_states`` (or its plain version), the plan's
        warm-up last: the kernel may cut the streams into segments that each
        warm up over it."""
        t = self.full_tables
        return (st.streams, t.classmap, t.comb, t.aux, t.root_row, t.segtable, t.BB,
                t.owner_mask, t.CB, t.root_cb, st.plan.overlap)

    def packed_states(self, st: StagedStreams) -> torch.Tensor:
        """int32 [T, S] on the device: the full set's 16-bit entry of every
        step (B12)."""
        return comb16_states(*self.states_args(st))

    @property
    def count_shift(self) -> int:
        """The count bit of the full set's entries.  The JAX engine masks
        with the count-minimized set's (``comb16_scan.py:1018``); the two are
        equal, since CB is 0 or 1 for both sets, 1 exactly where some state
        matches, and minimizing keeps every state's count."""
        return self.c16_full.count_shift

    def _pk_states(self, pk: torch.Tensor) -> torch.Tensor:
        """States of the full set's entries: its inverse base table."""
        return self._inv_base[pk.long() & self.c16_full.base_mask]


__all__ = [
    "MAX_COUNT16",
    "Comb16AcEngine",
    "Comb16GroupTables",
    "Comb16Machine",
    "Comb16StickyTables",
    "Comb16Tables",
    "build_comb16",
    "build_comb16_uniform",
    "build_sticky16_uniform",
    "comb16_structure_cost",
]
