"""Composed case-folding DFA: IgnoreCase matching on RAW bytes.

The reference lowers each haystack code point inside the hot loop
(``runWithCase``, ``src/Data/Text/AhoCorasick/Automaton.hs:468-480``); our
engines previously lowered the whole haystack up front (a host transducer
pass) and scanned the lowered bytes.  Both put a lowering stage on the hot
path.  This module removes it entirely: the UTF-8 strict-streaming lowering
transducer (``utf8.decode_strict`` semantics) is *composed with the match
DFA at build time*, producing an ordinary byte-DFA :class:`AcMachine` that
scans the RAW haystack — so every engine (scalar, C++, the CUDA bitap,
dense, comb16 and comb32 kernels) runs IgnoreCase at full CaseSensitive
speed, and match positions come out in raw byte coordinates natively (the
reference's ``matchPos`` contract, ``Automaton.hs:98-105``).

The port's copy of ``alfred_margaret_tpu/models/case_dfa.py``, over the
port's ``utils.utf8`` and ``models.ac``; ``tests/test_torch_case.py`` pins
``compose_build`` to the original.

Key facts making the composition exact and small:

* With **whole-code-point needles** (every needle's byte string parses as
  complete strict-valid sequences — checked by :func:`eligible`), a match
  can only end on the *final* byte of a raw unit: needles end with ASCII or
  a final continuation byte, while mid-emission states correspond to stream
  suffixes ending in an incomplete sequence.  Hence per-*state* match
  counts survive composition — no per-transition counts needed anywhere.
* A byte ``b`` occurring in no needle has an all-root ``delta`` column, so
  any emission containing a non-needle byte drives the match DFA to a
  **constant** final state: almost every code point's behavior collapses to
  one of a handful of classes, and pending (mid-sequence) transducer states
  whose completions are all constant are independent of the match state —
  the composite automaton stays within a few states of the original.

Construction: classify all code points by induced behavior, classify
pending prefixes bottom-up, BFS the reachable product, then Moore-minimize.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Tuple

import numpy as np

from ..utils import utf8
from .ac import AcMachine, build as ac_build

#: Lead byte ranges of strict UTF-8 (first-trail ranges per lead).
_LEAD2 = (0xC2, 0xDF)
_LEAD3 = (0xE0, 0xEF)
_LEAD4 = (0xF0, 0xF4)


def _d1_range(lead: int) -> Tuple[int, int]:
    if lead == 0xE0:
        return 0xA0, 0xBF
    if lead == 0xED:
        return 0x80, 0x9F
    if lead == 0xF0:
        return 0x90, 0xBF
    if lead == 0xF4:
        return 0x80, 0x8F
    return 0x80, 0xBF


def needle_whole_cps(needle: bytes) -> bool:
    """True iff the needle parses as complete strict-valid sequences."""
    i, n = 0, len(needle)
    while i < n:
        consumed, _, valid = utf8.decode_strict(needle, i)
        if not valid:
            return False
        i += consumed
    return True


def eligible(needles: Iterable[bytes]) -> bool:
    """Whether the composed-DFA path preserves exact lowered-scan semantics
    for this needle set (callers fall back to the host lowering path when
    not — arbitrary-byte needles can match inside emission interiors, which
    a per-state-count DFA cannot express)."""
    return all(needle_whole_cps(utf8.to_bytes(n)) for n in needles)


def max_raw_match_bytes(needles: Iterable[bytes]) -> int:
    """Max raw-byte span any needle can match: per needle code point, the
    longest minimal encoding among its casing variants (everything that
    lowercases to it — under strict lowering only minimal encodings decode,
    so overlong forms can never match).  K (3 bytes) matching needle 'k'
    (1 byte) is the canonical case."""
    best = 0
    for n in needles:
        data = utf8.to_bytes(n)
        span = 0
        i = 0
        while i < len(data):
            consumed, cp, valid = utf8.decode_strict(data, i)
            i += consumed
            if not valid:
                span += 1
                continue
            variants = utf8.unlower_code_point(chr(cp)) or chr(cp)
            span += max(
                max((utf8.num_code_units(ord(v)) for v in variants), default=1),
                consumed,
            )
        best = max(best, span)
    return best


def _cp_classes(delta: np.ndarray):
    """Classify all code points by their induced product behavior.

    A code point's emission (the UTF-8 bytes of its lowered cp) drives the
    match DFA to a state-dependent final state only when EVERY emission
    byte occurs in some needle ("allrel").  Otherwise the walk is constant
    root: the first non-relevant byte has an all-root delta column, and the
    remaining emission bytes are trail bytes, on which root has no
    transitions (whole-code-point needles start with ASCII or a lead byte).
    So the classification reduces to: class 0 = "constant, final root" for
    every non-allrel cp, one class per distinct lowered cp among allrel cps
    (equal lowered cp <=> equal emission).

    Returns (class_of int32[MAX_CP], cls_dep bool[n_cls],
    cls_final int64[n_cls], cls_emit list of emission byte lists for dep
    classes at index class-1, rel bool[256]).
    """
    lc = utf8.LOWER_TABLE  # int32, identity except lowercase mappings
    elen = (np.searchsorted([0x80, 0x800, 0x10000], lc, side="right") + 1).astype(np.int8)
    lead_base = np.array([0, 0, 0xC0, 0xE0, 0xF0], dtype=np.int32)
    b0 = lead_base[elen] | (lc >> ((elen.astype(np.int32) - 1) * 6))
    rel = (delta != 0).any(axis=0)  # byte occurs in some needle
    cidx = np.flatnonzero(rel[b0])  # lead byte relevant: allrel candidates
    lcc = lc[cidx].astype(np.int64)
    ee = elen[cidx]
    cb1 = np.where(
        ee == 2,
        0x80 | (lcc & 0x3F),
        np.where(ee == 3, 0x80 | ((lcc >> 6) & 0x3F), 0x80 | ((lcc >> 12) & 0x3F)),
    )
    cb2 = np.where(ee == 3, 0x80 | (lcc & 0x3F), 0x80 | ((lcc >> 6) & 0x3F))
    cb3 = 0x80 | (lcc & 0x3F)
    allrel = np.ones(len(cidx), dtype=bool)
    allrel &= np.where(ee > 1, rel[cb1], True)
    allrel &= np.where(ee > 2, rel[cb2], True)
    allrel &= np.where(ee > 3, rel[cb3], True)
    didx = cidx[allrel]
    dep_lcs, dep_inv = np.unique(lc[didx], return_inverse=True)
    class_of = np.zeros(utf8.MAX_CP, dtype=np.int32)
    class_of[didx] = 1 + dep_inv
    n_cls = 1 + len(dep_lcs)
    cls_dep = np.zeros(n_cls, dtype=bool)
    cls_dep[1:] = True
    cls_final = np.zeros(n_cls, dtype=np.int64)
    cls_emit = [utf8.unicode2utf8(int(x)) for x in dep_lcs]
    return class_of, cls_dep, cls_final, cls_emit, rel


class _PendClass:
    """A behavioral class of pending (mid-sequence) transducer states."""

    __slots__ = ("pid", "row", "flush_const", "flush_vec", "m_free", "rep_bytes")

    def __init__(self, pid, row, flush_const, flush_vec, m_free, rep_bytes):
        self.pid = pid
        self.row = row  # int64[256] encoded outcome per next byte
        self.flush_const = flush_const  # int or None
        self.flush_vec = flush_vec  # int64[S] or None
        self.m_free = m_free
        self.rep_bytes = rep_bytes  # a representative pending byte tuple


# Outcome row encoding: complete -> cp_class_id; continue -> (1 << 41) | pid;
# interrupt -> _INTERRUPT.
_CONT = 1 << 41
_INTERRUPT = 1 << 42


def compose_build(
    pairs: Iterable[Tuple[utf8.TextLike, Any]], machine: AcMachine = None
) -> AcMachine:
    """Build the composed IgnoreCase byte-DFA for (lowercase) needle pairs.

    The result is a drop-in :class:`AcMachine`: scanning it CaseSensitively
    over the RAW haystack produces exactly the matches (values, counts, and
    raw end positions) of lowering the haystack with the strict streaming
    transducer and scanning the lowered bytes with ``ac.build(pairs)`` —
    the contract is pinned by tests against that oracle.  Needles must be
    whole-code-point byte strings (:func:`eligible`); needles containing
    uppercase simply never match (the ``runLower`` contract,
    ``Automaton.hs:551-553``).

    ``machine`` may pass the already-built ``ac.build(pairs)`` to skip
    rebuilding it.
    """
    pairs = [(utf8.to_bytes(n), v) for n, v in pairs]
    M = machine if machine is not None else ac_build(pairs)
    if not eligible([n for n, _ in pairs]):
        raise ValueError("compose_build requires whole-code-point needles")
    delta = M.delta.astype(np.int64)
    S = delta.shape[0]

    class_of, cls_dep, cls_final, cls_emit, rel = _cp_classes(delta)

    ascii_lower = np.arange(256, dtype=np.int64)
    ascii_lower[ord("A") : ord("Z") + 1] += 0x20

    # ------------------------------------------------------------------
    # Pending classes, bottom-up (deepest first).
    # ------------------------------------------------------------------
    pend_classes: List[_PendClass] = []
    pend_lookup: Dict[Tuple, int] = {}

    def _flush_key(bytes_tuple: Tuple[int, ...]):
        """(const_state, None) when some byte is non-relevant — the walk
        passes through root there (``delta[s, non-rel] == 0`` for all s),
        so walking from root is exact.  Else (None, composed vector)."""
        if not all(rel[b] for b in bytes_tuple):
            s = 0
            for b in bytes_tuple:
                s = int(delta[s, b])
            return s, None
        vec = np.arange(S, dtype=np.int64)
        for b in bytes_tuple:
            vec = delta[vec, b]
        return None, vec

    def _intern(row: np.ndarray, bytes_tuple: Tuple[int, ...]) -> int:
        fc, fv = _flush_key(bytes_tuple)
        key = (row.tobytes(), fc if fc is not None else ("v", fv.tobytes()))
        pid = pend_lookup.get(key)
        if pid is not None:
            return pid
        # m_free: constant flush, no dep completions, all children m_free.
        m_free = fc is not None
        if m_free:
            for v in np.unique(row):
                v = int(v)
                if v == _INTERRUPT:
                    continue
                if v & _CONT:
                    if not pend_classes[v & (_CONT - 1)].m_free:
                        m_free = False
                        break
                elif cls_dep[v]:
                    m_free = False
                    break
        pid = len(pend_classes)
        pend_classes.append(_PendClass(pid, row, fc, fv, m_free, bytes_tuple))
        pend_lookup[key] = pid
        return pid

    trail = np.arange(0x80, 0xC0, dtype=np.int64)

    def _complete_row(cp_base: int) -> np.ndarray:
        """Row for a pending one trail short of completion: trail t
        completes cp_base + (t & 0x3F)."""
        row = np.full(256, _INTERRUPT, dtype=np.int64)
        row[0x80:0xC0] = class_of[cp_base + (trail & 0x3F)]
        return row

    pclass0 = {}  # lead byte -> pending class id
    # 2-byte leads: one trail completes.
    for L in range(_LEAD2[0], _LEAD2[1] + 1):
        pclass0[L] = _intern(_complete_row((L & 0x1F) << 6), (L,))
    # 3-byte leads: (L) -> (L, d1) -> complete.
    for L in range(_LEAD3[0], _LEAD3[1] + 1):
        lo, hi = _d1_range(L)
        row = np.full(256, _INTERRUPT, dtype=np.int64)
        for d1 in range(lo, hi + 1):
            child = _intern(
                _complete_row(((L & 0x0F) << 12) | ((d1 & 0x3F) << 6)), (L, d1)
            )
            row[d1] = _CONT | child
        pclass0[L] = _intern(row, (L,))
    # 4-byte leads: (L) -> (L, d1) -> (L, d1, t2) -> complete.
    for L in range(_LEAD4[0], _LEAD4[1] + 1):
        lo, hi = _d1_range(L)
        row1 = np.full(256, _INTERRUPT, dtype=np.int64)
        for d1 in range(lo, hi + 1):
            row2 = np.full(256, _INTERRUPT, dtype=np.int64)
            base12 = ((L & 0x07) << 18) | ((d1 & 0x3F) << 12)
            for t2 in range(0x80, 0xC0):
                child3 = _intern(_complete_row(base12 | ((t2 & 0x3F) << 6)), (L, d1, t2))
                row2[t2] = _CONT | child3
            child2 = _intern(row2, (L, d1))
            row1[d1] = _CONT | child2
        pclass0[L] = _intern(row1, (L,))

    # ------------------------------------------------------------------
    # Product automaton, vectorized.  Composite ids:
    #   m                  empty-pending (m, ·), m in [0, S)
    #   S + j*S + m        the j-th m-dependent pending class, per m
    #   S + n_dep*S + k    the k-th m-free pending class (m collapses to 0)
    # Whole (class x m) blocks are built as numpy matrices; a reachability
    # pass then prunes unreached (m, pending) combinations before
    # minimization.
    # ------------------------------------------------------------------
    deps = [pc.pid for pc in pend_classes if not pc.m_free]
    frees = [pc.pid for pc in pend_classes if pc.m_free]
    dep_index = {pid: j for j, pid in enumerate(deps)}
    free_index = {pid: k for k, pid in enumerate(frees)}
    n_dep = len(deps)
    n_comp = S + n_dep * S + len(frees)
    if n_comp > 400_000:
        raise ValueError(
            f"composition product too large ({n_comp} pre-prune states); "
            "use the lowering fallback"
        )
    marange = np.arange(S, dtype=np.int64)

    def _pend_cid(p: int):
        """Composite id of pending class ``p``: an (S,) vector (one per m)
        for m-dependent classes, a scalar for m-free ones."""
        if pend_classes[p].m_free:
            return S + n_dep * S + free_index[p]
        return S + dep_index[p] * S + marange

    # Per state-dependent cp class: final match state of its emission
    # walked from every m at once.
    dep_final: Dict[int, np.ndarray] = {}
    for c in range(1, len(cls_dep)):
        s = marange
        for b in cls_emit[c - 1]:
            s = delta[s, b]
        dep_final[c] = s

    # Empty-pending rows: ASCII lowers inline, leads enter their pending
    # class, any other byte is an invalid standalone unit emitted as-is.
    E = np.empty((S, 256), dtype=np.int64)
    E[:, :128] = delta[:, ascii_lower[:128]]
    for b in range(128, 256):
        E[:, b] = _pend_cid(pclass0[b]) if b in pclass0 else delta[:, b]

    # Pending rows.  m-free classes see only constants in their rows (their
    # definition requires constant flush, no dep completions, m-free
    # children), so one row at m=0 suffices.
    blocks = [E]
    for pids, ms in ((deps, marange), (frees, np.zeros(1, dtype=np.int64))):
        for p in pids:
            pc = pend_classes[p]
            R = np.empty((len(ms), 256), dtype=np.int64)
            if pc.flush_const is not None:
                m_f = np.full(len(ms), pc.flush_const, dtype=np.int64)
            else:
                m_f = pc.flush_vec[ms]
            for b in range(256):
                v = int(pc.row[b])
                if v == _INTERRUPT:
                    R[:, b] = E[m_f, b]
                elif v & _CONT:
                    R[:, b] = _pend_cid(v & (_CONT - 1))
                elif cls_dep[v]:
                    R[:, b] = dep_final[v][ms]
                else:
                    R[:, b] = cls_final[v]
            blocks.append(R)
    cdelta = np.concatenate(blocks, axis=0)

    # Reachability prune from the root (= empty state of m=0 = id 0).
    reach = np.zeros(n_comp, dtype=bool)
    reach[0] = True
    frontier = np.array([0], dtype=np.int64)
    while len(frontier):
        nxt = np.unique(cdelta[frontier])
        frontier = nxt[~reach[nxt]]
        reach[frontier] = True
    keep = np.flatnonzero(reach)
    relabel = np.full(n_comp, -1, dtype=np.int64)
    relabel[keep] = np.arange(len(keep))
    cdelta = relabel[cdelta[keep]]
    n_comp = len(keep)

    # Outputs / counts: empty-pending states inherit the match state's.
    m_of = np.where(keep < S, keep, -1)
    out_sig: List[Tuple] = [
        tuple(M.outputs(int(m))) if m >= 0 else () for m in m_of
    ]

    # ------------------------------------------------------------------
    # Moore minimization (partition refinement over the 256 columns).
    # ------------------------------------------------------------------
    sig_ids = {s: j for j, s in enumerate(dict.fromkeys(out_sig))}
    block = np.array([sig_ids[s] for s in out_sig], dtype=np.int32)
    n_blocks = len(sig_ids)
    while True:
        # Exact row interning via byte keys: O(n * 257) with no sort
        # (np.unique(axis=0) void-record sorting is ~100x slower here).
        key = np.ascontiguousarray(
            np.concatenate([block[:, None], block[cdelta]], axis=1), dtype=np.int32
        )
        row_ids: Dict[bytes, int] = {}
        newblock = np.empty(n_comp, dtype=np.int32)
        for s in range(n_comp):
            newblock[s] = row_ids.setdefault(key[s].tobytes(), len(row_ids))
        if len(row_ids) == n_blocks:
            break
        block, n_blocks = newblock, len(row_ids)
    # Renumber blocks by first occurrence, root's block first.
    first_idx: Dict[int, int] = {}
    for s in range(n_comp):
        first_idx.setdefault(int(block[s]), s)
    blocks_sorted = sorted(first_idx, key=lambda b: (b != int(block[0]), first_idx[b]))
    order = {b: j for j, b in enumerate(blocks_sorted)}
    n_min = len(blocks_sorted)
    newid = np.array([order[int(b)] for b in block], dtype=np.int64)
    rep_of = np.array([first_idx[b] for b in blocks_sorted], dtype=np.int64)
    delta_min = newid[cdelta[rep_of]].astype(np.int32)

    out_offset = np.zeros(n_min + 1, dtype=np.int32)
    out_values: List[int] = []
    for j in range(n_min):
        sig = out_sig[int(rep_of[j])]
        out_values.extend(sig)
        out_offset[j + 1] = len(out_values)
    match_count = np.diff(out_offset).astype(np.int32)

    # Failure links (comb default-row centers): map through the M machine's
    # links for empty-pending representatives; pendings fail to root.  The
    # empty composite id of match state m is m itself (pre-prune).
    fail = np.zeros(n_min, dtype=np.int32)
    if M.fail is not None:
        for j in range(n_min):
            m = int(m_of[int(rep_of[j])])
            if m >= 0:
                fm = int(relabel[int(M.fail[m])])
                if fm >= 0:
                    fail[j] = int(newid[fm])

    return AcMachine(
        delta=delta_min,
        out_offset=out_offset,
        out_values=np.asarray(out_values, dtype=np.int32),
        match_count=match_count,
        values=M.values,
        needles=M.needles,
        max_needle_bytes=max_raw_match_bytes([n for n, _ in pairs]) + 4,
        fail=fail,
        composed_ci=True,
    )


__all__ = ["compose_build", "eligible", "max_raw_match_bytes", "needle_whole_cps"]
