"""Needle-grouped engine for needle sets that no single-pass engine holds,
over the fused CUDA kernels B9 (count) and B11 (containsAny).

Counterpart of ``alfred_margaret_tpu/ops/grouped.py``: ``partition_adaptive``,
``partition_uniform16`` and the trie-estimate ``partition_needles`` are copied
as numpy (that module imports ``jax``; ``tests/test_torch_grouped.py`` and
``tests/test_torch_host.py`` pin the copies), and ``GroupedAcEngine``
takes the place of ``GroupedPallasAcEngine`` with the adaptive partition
(the JAX engine's default; its ``"entry"`` alternative is not ported).

The needle set is partitioned into groups whose sub-automata each fit a
single-pass engine of ``ops.comb_scan.make_engine``, and every group scans
the one staged corpus (all groups take the full machine's warm-up overlap).
Semantics are preserved exactly:

* counts and value presence are sums and unions over groups (needle sets are
  disjoint across groups);
* duplicate needles stay in one group, so the reference's payload-merge
  emission order (``Automaton.hs:259-263``) is untouched;
* the cross-group match merge orders by ``(end, -needle_byte_len)``: the
  reference emits same-end matches in state-output order, own (longest)
  needle first, then failure-chain (strictly shorter) suffixes
  (``Automaton.hs:367-380``), and same-end same-length needles are
  byte-identical, hence in the same group.

``count_matches`` runs ``screen_count`` once (``kernels/screen_count.py``:
a suffix screen of the needles' keys and exact verification) wherever the
needle set suits it, which ``plan_screen`` decides from the set alone at
engine build: no needle under 4 bytes or over 16, at most 8 distinct needles
sharing a key, raw bytes.  Otherwise it runs B9 once over every group of a
second, uniform partition (``partition_uniform16``: every group builds comb16
under one field split, so one kernel serves them all).  ``contains_any``
runs the stride-2 screen B14 with up to 12 words, then B11 once over the
sticky view's uniform groups.  ``contains_all`` and ``all_matches`` run each group's match
extraction and merge: B15 and B17 for a comb32 group, the hit bitmap (B6,
with the comb16 step B13) for the others.  Where no uniform partition fits,
or the JAX package's economics guards refuse it (kept as they are, and fed
the same groups, so both packages take the same path for a set; re-deriving
them on the H100 is ROADMAP Queue A item 7), the count and containsAny run
per group (B15, B16, B8, B10, B1-B4).  A fused launch that fails raises:
nothing falls back.  The build, each fused table set and each count pass
open the spans ``amt.group.build``, ``amt.group.fuse`` and
``amt.group.pass`` (``utils/trace.py``), the screen's launch
``amt.group.screen`` inside its pass, recorded only under a running
profiler.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..kernels.comb16_grouped import (
    comb16_contains_grouped,
    comb16_count_grouped,
    comb16_count_grouped_plain,
)
from ..kernels.screen_count import plan_screen, screen_count
from ..models import ac
from ..models.minimize import count_minimized, minimize_sticky
from ..utils import trace, utf8
from ..utils.device import resolve_device
from .comb16_scan import (
    Comb16GroupTables,
    build_comb16,
    build_comb16_uniform,
    build_sticky16_uniform,
)
from .comb_scan import make_engine, plan_pallas
from .filter_scan import attach_filter, filter_contains
from .pallas_scan import MAX_ROWS, CapacityError, StagedStreams, _StickyView, sum_live
from .xla_scan import expand_hits


def partition_needles(machine: ac.AcMachine, max_rows: int = MAX_ROWS) -> List[List[int]]:
    """Partition value ids (pair indices) into groups whose sub-automata fit
    ``max_rows * 128`` packed entries. Duplicate needles share a group."""
    budget = max_rows * 128
    groups: List[List[int]] = []
    needle_group: dict = {}

    cur: List[int] = []
    cur_trie: dict = {}
    cur_nodes = 1  # root
    cur_bytes: set = set()

    def close():
        nonlocal cur, cur_trie, cur_nodes, cur_bytes
        if cur:
            groups.append(cur)
        cur, cur_trie, cur_nodes, cur_bytes = [], {}, 1, set()

    def try_add(needle: bytes) -> bool:
        """Insert into the running trie estimate; True if still in budget."""
        nonlocal cur_nodes
        new_nodes = 0
        node = cur_trie
        for b in needle:
            nxt = node.get(b)
            if nxt is None:
                nxt = {}
                node[b] = nxt
                new_nodes += 1
            node = nxt
        cur_nodes += new_nodes
        cur_bytes.update(needle)
        return cur_nodes * (len(cur_bytes) + 1) <= budget

    for vid, needle in enumerate(machine.needles):
        prev = needle_group.get(needle)
        if prev is not None:
            # Duplicate: must join the first occurrence's group (may make
            # that group's estimate stale, but duplicates add no trie nodes
            # or bytes, so the bound is unaffected).
            if prev == -1:
                cur.append(vid)
            else:
                groups[prev].append(vid)
            continue
        single_entries = (len(needle) + 1) * (len(set(needle)) + 1)
        if single_entries > budget:
            raise CapacityError(
                f"needle of {len(needle)} bytes cannot fit a {budget}-entry group"
            )
        if not try_add(needle):
            close()
            # Re-fix group indices for needles closed into the last group.
            for n, g in needle_group.items():
                if g == -1:
                    needle_group[n] = len(groups) - 1
            try_add(needle)
        cur.append(vid)
        needle_group[needle] = -1  # -1 == current open group
    close()
    for n, g in needle_group.items():
        if g == -1:
            needle_group[n] = len(groups) - 1
    return groups


def partition_adaptive(machine: ac.AcMachine, max_rows: int = MAX_ROWS, with_rows: bool = False):
    """Group needles by *exact* sub-machine structure cost, dense or comb.

    Raises :class:`CapacityError` for empty-needle machines: the empty
    needle's matches depend on the union of all groups' states, so such
    machines are not needle-partitionable.

    Group sizes are found by exponential growth and bisection on trial
    ``ac.build`` + ``plan_pallas`` evaluations, minimizing the summed TPU
    gather cost group by group (the JAX package's currency, kept so that both
    packages partition alike).
    """
    if any(len(n) == 0 for n in machine.needles):
        raise CapacityError("empty needle cannot be needle-partitioned")
    first: dict = {}
    uniq: List[Tuple[bytes, List[int]]] = []
    for vid, needle in enumerate(machine.needles):
        j = first.get(needle)
        if j is None:
            first[needle] = len(uniq)
            uniq.append((needle, [vid]))
        else:
            uniq[j][1].append(vid)
    N = len(uniq)

    rows_of: dict = {}

    def cost(i: int, g: int):
        """Per-byte gather cost of a [i, i+g) group, or None if nothing fits."""
        if (i, g) not in rows_of:
            sub = ac.build([(uniq[i + j][0], 0) for j in range(g)])
            try:
                _, rows_of[i, g] = plan_pallas(sub, max_rows)
            except CapacityError:
                rows_of[i, g] = None
        return rows_of[i, g]

    groups: List[List[int]] = []
    group_rows: List[int] = []
    i = 0
    while i < N:
        # Grow the group along a geometric ladder while the gather cost PER
        # NEEDLE keeps improving.
        g = min(32, N - i)
        c = cost(i, g)
        if c is None:
            # Even the seed size overflows: shrink until something fits.
            g //= 2
            while g >= 1 and cost(i, g) is None:
                g //= 2
            if g == 0:
                raise CapacityError(
                    f"needle {uniq[i][0]!r} alone exceeds the {max_rows}-row budget"
                )
            best_g, best_c = g, cost(i, g)
        else:
            best_g, best_c, best_cpn = g, c, c / g
            while g < N - i:
                g = min(g * 2, N - i)
                c = cost(i, g)
                if c is None:
                    break
                cpn = c / g
                if cpn < best_cpn * 0.98:
                    best_g, best_c, best_cpn = g, c, cpn
                else:
                    break  # diminishing returns: stop growing
            # One midpoint probe: the geometric ladder can step over the
            # comb16 capacity knee (e.g. 96 beats both 64 and 128).
            m = best_g + best_g // 2
            if m <= N - i and m != best_g:
                cm_ = cost(i, m)
                if cm_ is not None and cm_ / m < best_cpn:
                    best_g, best_c = m, cm_
        groups.append([v for _, vids in uniq[i : i + best_g] for v in vids])
        group_rows.append(best_c)
        i += best_g
    if with_rows:
        return groups, group_rows
    return groups


def partition_uniform16(machine: ac.AcMachine, max_rows_total: int = MAX_ROWS,
                        view: str = "count"):
    """Partition value ids into groups that ALL build comb16 under ONE shared
    field split: the precondition of the fused grouped kernels B9 and B11.

    Every candidate group is trial-built with the forced split, so the
    uniform build that follows cannot overflow.  Counts and containsAny do
    not depend on group boundaries (sums and unions over disjoint needle
    sets), so the fused kernels may use this partition while extraction uses
    the adaptive one.  ``view`` selects the machine the trial builds (and the
    kernel) scan: ``"count"``, the count-minimized quotient (B9), or
    ``"sticky"``, the minimized absorbing view (B11); each kernel family
    partitions against its own view.

    Returns ``(groups, subs, subs_min, split)``: vid groups, each group's
    machine, its ``view``-minimized quotient, and the validated
    ``(CB, OB, BB)`` split.  Raises :class:`CapacityError` when some needle
    fits no uniform split alone.
    """
    def quotient(sub: ac.AcMachine):
        mmin = count_minimized(sub)
        if view == "sticky":
            return minimize_sticky(_StickyView(mmin))
        return mmin

    first: dict = {}
    uniq: List[Tuple[bytes, List[int]]] = []
    for vid, needle in enumerate(machine.needles):
        j = first.get(needle)
        if j is None:
            first[needle] = len(uniq)
            uniq.append((needle, [vid]))
        else:
            uniq[j][1].append(vid)
    N = len(uniq)

    cache: dict = {}

    def trial(i: int, g: int, split):
        """(rows, sub, sub_min) for group [i, i+g) under ``split``, or None."""
        key = (i, g, split)
        if key not in cache:
            pairs = [
                (machine.needles[v], machine.values[v])
                for _, vids in uniq[i : i + g]
                for v in vids
            ]
            sub = ac.build(pairs)
            try:
                sub_min = quotient(sub)
                c16 = build_comb16(sub_min, max_rows_total, split=split)
                cache[key] = (c16.rows_c + c16.rows_a + 2, sub, sub_min)
            except CapacityError:
                cache[key] = None
        return cache[key]

    # Count views carry per-state weights (CB=1); sticky views encode hits
    # in the absorbing base alone (CB=0, one more base bit).
    CB = 0 if view == "sticky" else 1
    last_err = None
    for OB in (5, 4):
        split = (CB, OB, 16 - CB - OB)
        groups: List[List[int]] = []
        subs: List[ac.AcMachine] = []
        subs_min: List[ac.AcMachine] = []
        i = 0
        failed = False
        while i < N:
            g = min(32, N - i)
            r = trial(i, g, split)
            if r is None:
                g //= 2
                while g >= 1 and trial(i, g, split) is None:
                    g //= 2
                if g == 0:
                    failed = True
                    break
                best_g, best_r = g, trial(i, g, split)
                best_cpn = best_r[0] / g
            else:
                best_g, best_r, best_cpn = g, r, r[0] / g
                # Same growth policy as partition_adaptive: geometric ladder
                # while rows-per-needle improves, one midpoint probe.
                while g < N - i:
                    g = min(g * 2, N - i)
                    r = trial(i, g, split)
                    if r is None:
                        break
                    cpn = r[0] / g
                    if cpn < best_cpn * 0.98:
                        best_g, best_r, best_cpn = g, r, cpn
                    else:
                        break
                mth = best_g + best_g // 2
                if mth <= N - i and mth != best_g:
                    rm = trial(i, mth, split)
                    if rm is not None and rm[0] / mth < best_cpn:
                        best_g, best_r = mth, rm
            groups.append([v for _, vids in uniq[i : i + best_g] for v in vids])
            subs.append(best_r[1])
            subs_min.append(best_r[2])
            i += best_g
        if not failed:
            return groups, subs, subs_min, split
        last_err = CapacityError(
            f"needle {uniq[i][0]!r} fits no uniform comb16 split alone"
        )
    raise last_err


@dataclass
class FusedGroups:
    """One fused table set: the uniform partition's vid groups and their
    stacked tables on the device."""

    groups: List[List[int]]
    tables: Comb16GroupTables


class GroupedAcEngine:
    """Multi-pass engine: needle groups that each fit a single-pass engine,
    one staging for all of them.

    ``partition_adaptive`` gives the groups; ``max_rows`` bounds every
    group's table and the fused kernels' uniform builds; ``n_streams`` and
    ``t_tile`` give the stream plan.  Raises :class:`CapacityError` for a machine with an empty
    needle (its matches depend on the union of every group's states) and
    when a needle fits no group alone."""

    def __init__(self, machine: ac.AcMachine, *, device="cuda", max_rows: int = MAX_ROWS,
                 n_streams: int = 32768, t_tile: int = 128):
        if any(len(n) == 0 for n in machine.needles):
            # The empty needle's root-piggyback quirk fires wherever the FULL
            # machine is non-root (Automaton.hs:367-380 flattening): the union
            # of all groups' non-root states, which per-group sums cannot
            # express.
            raise CapacityError(
                "empty needle cannot be needle-partitioned: its matches "
                "depend on the union of every group's states"
            )
        self.machine = machine
        self.device = resolve_device(device)
        self.max_rows = max_rows
        with trace.span("amt.group.build"):
            groups = partition_adaptive(machine, max_rows)
            if not groups:
                raise CapacityError("no needles to group")
            self.groups: List[List[int]] = []
            self.engines: list = []
            self.vid_maps: List[np.ndarray] = []
            # Every group engine takes the FULL machine's overlap, so one staged
            # stream layout serves every group pass.
            self.overlap = max(0, machine.max_needle_bytes - 1)
            kw = dict(max_rows=max_rows, overlap=self.overlap, n_streams=n_streams, t_tile=t_tile)

            def add_group(vids: List[int]):
                # The adaptive partitioner scores unique value-less needles; the
                # real group (payload merge, placement) can still overflow in rare
                # corners: split and retry.
                pairs = [(machine.needles[v], machine.values[v]) for v in vids]
                try:
                    eng = make_engine(ac.build(pairs), self.device, **kw)
                except CapacityError:
                    # Split on first-occurrence boundaries so duplicates stay
                    # together.
                    seen: dict = {}
                    per_needle: List[List[int]] = []
                    for v in vids:
                        n = machine.needles[v]
                        if n in seen:
                            per_needle[seen[n]].append(v)
                        else:
                            seen[n] = len(per_needle)
                            per_needle.append([v])
                    if len(per_needle) == 1:
                        raise  # one unique needle: it cannot split further
                    mid = max(1, len(per_needle) // 2)
                    add_group([v for g in per_needle[:mid] for v in g])
                    add_group([v for g in per_needle[mid:] for v in g])
                    return
                self.groups.append(vids)
                self.engines.append(eng)
                self.vid_maps.append(np.asarray(vids, dtype=np.int64))

            for vids in groups:
                add_group(vids)
            self.S, self.t_tile = self.engines[0].S, self.engines[0].t_tile
            self._needle_len = np.fromiter((len(n) for n in machine.needles), np.int64,
                                           len(machine.needles))
            self._fused: Optional[FusedGroups] = None
            self._fused_sticky: Optional[FusedGroups] = None
            self._fused_tried = self._fused_sticky_tried = False
            # The count's suffix screen (``kernels/screen_count.py``), or None
            # where the needle set does not suit it: then B9 or the groups'
            # own passes count.
            self._screen = plan_screen(machine, self.device)
            # One screen of up to 12 words in front of every group: it covers every
            # needle, so the groups' own screens would only fire again on the same
            # corpus.  Where it does not plan (very large sets), they keep theirs.
            if attach_filter(self, machine, max_words=12):
                for e in self.engines:
                    if hasattr(e, "_filter_tables"):
                        e._filter_lay = e._filter_tables = None

    # -- staging --------------------------------------------------------------

    def stage(self, data: np.ndarray) -> StagedStreams:
        """Stage a corpus on the device once, for every group."""
        return self.engines[0].stage(data)

    def _stage(self, text: utf8.TextLike) -> Optional[StagedStreams]:
        data = utf8.to_u8(text)
        return None if len(data) == 0 else self.stage(data)

    def adopt_staged(self, st: Optional[StagedStreams]) -> Optional[StagedStreams]:
        """``st`` when every group can scan it, else None: every group pass
        scans the shared staging, so its overlap must cover the FULL
        machine's warm-up, not just group 0's."""
        if st is None or st.plan.overlap < self.overlap:
            return None
        return self.engines[0].adopt_staged(st)

    @property
    def n_groups(self) -> int:
        return len(self.engines)

    @property
    def total_rows(self) -> int:
        """Summed table rows across the group passes (the JAX package's cost
        of a per-group scan, which its fusion guards weigh)."""

        def rows(e):
            if hasattr(e, "c16"):
                return e.c16.rows_total
            return e.comb.rows_total if hasattr(e, "comb") else e.comp.rows

        return sum(rows(e) for e in self.engines)

    # -- the fused table sets -------------------------------------------------

    def _fused_setup(self) -> Optional[FusedGroups]:
        """The count view's uniform table set for B9, built at first use, or
        None: fewer than two groups, no uniform partition of two or more
        groups, or more rows than the JAX package's guard allows against the
        per-group passes."""
        if not self._fused_tried:
            self._fused_tried = True
            if len(self.engines) >= 2:
                with trace.span("amt.group.fuse"):
                    try:
                        groups, _, subs, split = partition_uniform16(self.machine, self.max_rows)
                        if len(subs) < 2:
                            raise CapacityError("single uniform group")
                        c16s, stacked = build_comb16_uniform(subs, self.max_rows, split=split)
                        cst = stacked["consts"]
                        rows = len(subs) * (cst["rows_c"] + cst["rows_a"] + 2)
                        # The JAX package's economics guard (TPU launch cost
                        # against row inflation), kept as it is.
                        if rows <= max(1.3 * self.total_rows,
                                       self.total_rows + 2 * len(self.engines)):
                            self._fused = FusedGroups(groups, Comb16GroupTables.from_stacked(
                                stacked, self.device, c16s=c16s))
                    except CapacityError:
                        self._fused = None
        return self._fused

    def _fused_sticky_setup(self) -> Optional[FusedGroups]:
        """The sticky view's uniform table set for B11, or None; tried only
        where the count fusion engaged (the same group economics)."""
        if self._fused_setup() is None:
            return None
        if not self._fused_sticky_tried:
            self._fused_sticky_tried = True
            with trace.span("amt.group.fuse"):
                try:
                    groups, _, svs, split = partition_uniform16(self.machine, self.max_rows,
                                                                view="sticky")
                    if len(svs) < 2:
                        raise CapacityError("single uniform sticky group")
                    c16s, stacked = build_sticky16_uniform([], self.max_rows, split=split,
                                                           views=svs)
                    cst = stacked["consts"]
                    rows = len(c16s) * (cst["rows_c"] + cst["rows_a"] + 2)
                    # The JAX package's guard: uniform rows against per-group
                    # sticky passes.
                    if rows <= 1.3 * sum(c.rows_c + c.rows_a + 2 for c in c16s):
                        self._fused_sticky = FusedGroups(
                            groups,
                            Comb16GroupTables.from_stacked(stacked, self.device, sticky=True,
                                                           c16s=c16s))
                except CapacityError:
                    self._fused_sticky = None
        return self._fused_sticky

    # -- counting: B9, or the groups' own kernels ------------------------------

    def _count_args(self, st: StagedStreams) -> tuple:
        f = self._fused_setup()
        if f is None:
            raise CapacityError("the fused grouped count did not engage")
        return (st.streams, st.warm, st.vend, f.tables, st.plan.overlap)

    def stream_counts(self, st: StagedStreams):
        """int32 [S] per-stream counts over all groups: one B9 launch.
        Raises ``CapacityError`` when the fused count did not engage."""
        return comb16_count_grouped(*self._count_args(st))

    def stream_counts_plain(self, st: StagedStreams):
        return comb16_count_grouped_plain(*self._count_args(st))

    def count_staged(self, st: StagedStreams) -> int:
        """Total count: one ``screen_count`` launch where the needle set
        suits the screen (in an ``amt.group.screen`` span), else one B9
        launch where the fused count engaged, else the sum of the groups' own
        counts; each pass, to its number, in an ``amt.group.pass`` span."""
        if self._screen is not None:
            with trace.span("amt.group.pass"):
                with trace.span("amt.group.screen"):
                    counts = screen_count(st.streams, st.warm, st.vend, self._screen,
                                          st.plan.overlap)
                return sum_live(counts, st.live_np)
        if self._fused_setup() is None:
            total = 0
            for e in self.engines:
                with trace.span("amt.group.pass"):
                    total += e.count_staged(st)
            return total
        with trace.span("amt.group.pass"):
            return sum_live(self.stream_counts(st), st.live_np)

    def count(self, text: utf8.TextLike) -> int:
        st = self._stage(text)
        return 0 if st is None else self.count_staged(st)

    # -- containsAny: the screen (B14), then B11 or the groups' own scans -----

    def sticky_args(self, st: StagedStreams) -> tuple:
        """Arguments of ``comb16_contains_grouped`` (or its plain version),
        the full machine's overlap last; raises ``CapacityError`` when the
        fused sticky scan did not engage."""
        fs = self._fused_sticky_setup()
        if fs is None:
            raise CapacityError("the fused grouped sticky scan did not engage")
        return (st.streams, st.vend, fs.tables, st.plan.overlap)

    def contains_staged(self, st: StagedStreams) -> bool:
        """The screen's answer where it has one, else one B11 launch where
        the fused sticky scan engaged, else the groups' own scans in order,
        stopping at the first group with a hit (the reference's ``Done True``
        early exit at group granularity, ``AhoCorasick/Searcher.hs:156-164``)."""
        got = filter_contains(self, st)
        if got is not None:
            return got
        if self._fused_sticky_setup() is None:
            return any(e.contains_staged(st) for e in self.engines)
        hits = comb16_contains_grouped(*self.sticky_args(st)).cpu().numpy()
        return bool(hits[st.live_np].any())

    def contains_staged_early(self, st: StagedStreams, n_segments=None) -> bool:
        """The grouped engine keeps the one-shot scans, as in the JAX package."""
        return self.contains_staged(st)

    def contains(self, text: utf8.TextLike) -> bool:
        st = self._stage(text)
        return st is not None and self.contains_staged(st)

    # -- allMatches and containsAll: each group's extraction -----------------

    def matches_arrays_staged(self, st: Optional[StagedStreams]) -> Tuple[np.ndarray, np.ndarray]:
        """(ends, value ids) in reference emission order across all groups."""
        all_ends: List[np.ndarray] = []
        all_vids: List[np.ndarray] = []
        if st is not None:
            for eng, vid_map in zip(self.engines, self.vid_maps):
                ends, sub_vids = expand_hits(eng.machine, *eng.match_positions_staged(st))
                all_ends.append(ends)
                all_vids.append(vid_map[sub_vids])
        ends = np.concatenate(all_ends) if all_ends else np.zeros(0, np.int64)
        vids = np.concatenate(all_vids) if all_vids else np.zeros(0, np.int64)
        order = np.lexsort((-self._needle_len[vids], ends))  # end asc, longer needle first
        return ends[order].astype(np.int64), vids[order].astype(np.int32)

    def matches_arrays(self, text: utf8.TextLike) -> Tuple[np.ndarray, np.ndarray]:
        return self.matches_arrays_staged(self._stage(text))

    def value_presence_staged(self, st: Optional[StagedStreams], n_values: int) -> np.ndarray:
        """bool [n_values]: the union of the groups' value presence, each
        group's engine answering over its own values (group-local, so never
        against the full machine)."""
        present = np.zeros(n_values, dtype=bool)
        if st is None:
            return present
        for eng, vid_map in zip(self.engines, self.vid_maps):
            sub = eng.value_presence_staged(st, len(eng.machine.values))
            present[vid_map[np.flatnonzero(sub)]] = True
        return present

    def value_presence(self, text: utf8.TextLike, n_values: int) -> np.ndarray:
        return self.value_presence_staged(self._stage(text), n_values)


__all__ = [
    "FusedGroups",
    "GroupedAcEngine",
    "partition_adaptive",
    "partition_needles",
    "partition_uniform16",
]
