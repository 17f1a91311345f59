"""Aho-Corasick automaton: offline construction of a dense byte-level DFA.

The port's copy of the parts of ``alfred_margaret_tpu/models/ac.py`` it uses:
``AcMachine`` (with ``map_values``), ``Match``, ``Step``, ``Done``,
``build``, ``validate_machine``, ``save_npz`` / ``load_npz`` (values
include the Replacer's ``Payload``), the scalar fold in both case modes (``run_with_case``,
``run_text``, ``run_lower``, ``all_matches``, ``count_matches``),
``needle_casings`` and ``presence_of_states``.
``tests/test_torch_host.py`` pins each to its original on seeded needle sets.

Every (state, byte) pair is resolved through the failure chains at build time
into a dense ``n_states x 256`` goto table, so matching is ``state =
delta[state, byte]``; output sets are flattened per state into a CSR array in
emission order (own needles first, longest/latest, then the failure chain's).
The empty needle's value rides the root and is emitted at every byte of a
code point boundary but never at the root itself.
"""

from __future__ import annotations

import ast
import json
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from ..utils import utf8
from ..utils.case import CASE_SENSITIVE, IGNORE_CASE, CaseSensitivity


class Match(NamedTuple):
    """A single match: ``pos`` is the byte (code unit) index one past the last
    byte of the match in *raw haystack coordinates* (``Automaton.hs:98-105``);
    ``value`` is the needle's payload."""

    pos: int
    value: Any


class Step(NamedTuple):
    """Continue folding with a new accumulator (``Next`` in ``Automaton.hs:398``)."""

    acc: Any


class Done(NamedTuple):
    """Stop folding and return this accumulator immediately."""

    acc: Any


@dataclass
class AcMachine:
    """A packed, DFA-ized Aho-Corasick machine over bytes.

    Arrays:
      delta:        int32 [n_states, 256] dense goto table (failure-resolved)
      out_offset:   int32 [n_states + 1]  CSR offsets into out_values
      out_values:   int32 [total_outputs] value ids, per state in emission
                    order (own needles first — longest/latest — then failure
                    chain outputs, mirroring ``Automaton.hs:367-380``)
      match_count:  int32 [n_states]      == diff(out_offset), the per-state
                    number of matches to emit (0 for root/mid-cp states)
    """

    delta: np.ndarray
    out_offset: np.ndarray
    out_values: np.ndarray
    match_count: np.ndarray
    values: List[Any]
    needles: List[bytes]
    max_needle_bytes: int
    # Debug / dot-dump info (small): trie edges and failure links.
    edge_src: np.ndarray = field(repr=False, default=None)
    edge_byte: np.ndarray = field(repr=False, default=None)
    edge_dst: np.ndarray = field(repr=False, default=None)
    fail: np.ndarray = field(repr=False, default=None)
    cp_complete: np.ndarray = field(repr=False, default=None)
    #: True for composed case-folding DFAs (``models.case_dfa``):
    #: ``needles`` are then the original-case needles while the delta does
    #: the folding, so no planner may match needle bytes.
    composed_ci: bool = False

    @property
    def n_states(self) -> int:
        return self.delta.shape[0]

    def outputs(self, state: int) -> Sequence[int]:
        """Value ids emitted at ``state``."""
        return self.out_values[self.out_offset[state] : self.out_offset[state + 1]]

    def map_values(self, f: Callable[[Any], Any]) -> "AcMachine":
        """The same machine with ``f`` applied to every value (the
        reference's ``deriving Functor`` on ``AcMachine``)."""
        return AcMachine(
            delta=self.delta,
            out_offset=self.out_offset,
            out_values=self.out_values,
            match_count=self.match_count,
            values=[f(v) for v in self.values],
            needles=self.needles,
            max_needle_bytes=self.max_needle_bytes,
            edge_src=self.edge_src,
            edge_byte=self.edge_byte,
            edge_dst=self.edge_dst,
            fail=self.fail,
            cp_complete=self.cp_complete,
            composed_ci=self.composed_ci,
        )


#: Artifact format version (bump on any incompatible field change).
_NPZ_VERSION = 2


def _value_to_json(v):
    """Typed JSON encoding of payload values: JSON scalars and containers,
    bytes, tuples and the Replacer's ``Payload`` (tagged ``__payload__``,
    as the JAX package writes it, so artifacts cross between the packages)."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, bytes):
        return {"__b__": v.decode("latin-1")}
    if isinstance(v, tuple):
        return {"__t__": [_value_to_json(x) for x in v]}
    if isinstance(v, list):
        return [_value_to_json(x) for x in v]
    if isinstance(v, dict):
        return {"__d__": [[_value_to_json(k), _value_to_json(x)] for k, x in v.items()]}
    from ..replacer import Payload

    if isinstance(v, Payload):
        return {
            "__payload__": [
                v.needle_priority,
                v.needle_length_bytes,
                v.needle_length_code_points,
                v.needle_replacement.decode("latin-1"),
            ]
        }
    raise TypeError(f"cannot persist value of type {type(v).__name__}")


def _value_from_json(v):
    if isinstance(v, dict):
        if "__b__" in v:
            return v["__b__"].encode("latin-1")
        if "__t__" in v:
            return tuple(_value_from_json(x) for x in v["__t__"])
        if "__d__" in v:
            return {_value_from_json(k): _value_from_json(x) for k, x in v["__d__"]}
        if "__payload__" in v:
            from ..replacer import Payload

            p, lb, lc, rep = v["__payload__"]
            return Payload(p, lb, lc, rep.encode("latin-1"))
        raise ValueError(f"unknown tagged value {sorted(v)}")
    if isinstance(v, list):
        return [_value_from_json(x) for x in v]
    return v


def save_npz(machine: AcMachine, path: str, extra: Optional[dict] = None) -> None:
    """Persist the packed dense tables for a cold start without a rebuild.
    Values round-trip through the typed-JSON codec; ``extra`` is a
    JSON-serializable metadata dict stored alongside (the Searcher stores
    its case mode there)."""
    np.savez_compressed(
        path,
        version=np.int64(_NPZ_VERSION),
        delta=machine.delta,
        out_offset=machine.out_offset,
        out_values=machine.out_values,
        match_count=machine.match_count,
        needles=np.array([n.decode("latin-1") for n in machine.needles]),
        values=np.array(json.dumps([_value_to_json(v) for v in machine.values])),
        extra=np.array(json.dumps(extra or {})),
        max_needle_bytes=np.int64(machine.max_needle_bytes),
    )


def load_npz(path: str, with_extra: bool = False):
    """Load a machine persisted by :func:`save_npz`; with ``with_extra``
    returns ``(machine, extra_dict)``."""
    z = np.load(path, allow_pickle=False)
    version = int(z["version"]) if "version" in z else 1
    if version > _NPZ_VERSION:
        raise ValueError(f"artifact version {version} is newer than this library")
    if version >= 2:
        values = [_value_from_json(v) for v in json.loads(str(z["values"]))]
    else:  # v1: repr/literal_eval of plain literals
        values = [ast.literal_eval(v) for v in z["values"].tolist()]
    machine = AcMachine(
        delta=z["delta"],
        out_offset=z["out_offset"],
        out_values=z["out_values"],
        match_count=z["match_count"],
        needles=[n.encode("latin-1") for n in z["needles"].tolist()],
        values=values,
        max_needle_bytes=int(z["max_needle_bytes"]),
    )
    if with_extra:
        extra = json.loads(str(z["extra"])) if "extra" in z else {}
        return machine, extra
    return machine


def presence_of_states(machine: AcMachine, hit_states, n_values: int) -> np.ndarray:
    """bool [n_values] presence vector from hit state ids — one vectorized
    CSR expansion instead of a Python loop over states x outputs."""
    present = np.zeros(n_values, dtype=bool)
    hs = np.unique(np.asarray(hit_states, dtype=np.int64))
    if len(hs) == 0:
        return present
    counts = machine.match_count[hs].astype(np.int64)
    hs = hs[counts > 0]
    counts = counts[counts > 0]
    if len(hs) == 0:
        return present
    base = np.repeat(machine.out_offset[hs].astype(np.int64), counts)
    ramp = np.arange(int(counts.sum()), dtype=np.int64) - np.repeat(
        np.cumsum(counts) - counts, counts
    )
    present[machine.out_values[base + ramp]] = True
    return present


def validate_machine(machine: AcMachine) -> None:
    """Structural invariants check (the debug analogue of the reference's
    bounds-checked ``at``/``uAt`` era, ``Automaton.hs:382-392``): every
    transition in range, CSR arrays consistent, match counts == CSR widths.
    Raises AssertionError on violation."""
    n = machine.n_states
    d = machine.delta
    assert d.shape == (n, 256), d.shape
    assert d.min() >= 0 and d.max() < n, "transition out of range"
    off = machine.out_offset
    assert len(off) == n + 1 and off[0] == 0
    assert (np.diff(off) >= 0).all(), "CSR offsets not monotone"
    assert off[-1] == len(machine.out_values)
    assert (machine.match_count == np.diff(off)).all(), "count/CSR mismatch"
    if len(machine.out_values):
        assert machine.out_values.min() >= 0
        assert machine.out_values.max() < len(machine.values)


def build(needles_with_values: Iterable[Tuple[utf8.TextLike, Any]]) -> AcMachine:
    """Construct the automaton for (needle, value) pairs (``Automaton.hs:176-200``).

    Duplicate needles merge their payloads with the later-inserted payload
    emitted first (``Automaton.hs:259-263`` — ``insertWith (++)`` prepends).
    """
    pairs = [(utf8.to_bytes(n), v) for n, v in needles_with_values]
    needles = [n for n, _ in pairs]
    values = [v for _, v in pairs]

    # --- Trie construction (buildTransitionMap, Automaton.hs:249-292) ---
    children: List[dict] = [{}]
    own: List[List[int]] = [[]]
    # pending continuation bytes expected at this state; 0 <=> path ends at a
    # code point boundary ("cp-complete").
    pending: List[int] = [0]
    depth: List[int] = [0]
    for vid, needle in enumerate(needles):
        s = 0
        for b in needle:
            nxt = children[s].get(b)
            if nxt is None:
                nxt = len(children)
                children[s][b] = nxt
                children.append({})
                own.append([])
                pend = utf8._LEAD_LEN[b] - 1 if pending[s] == 0 else pending[s] - 1
                pending.append(int(pend))
                depth.append(depth[s] + 1)
            s = nxt
        own[s].insert(0, vid)  # later-inserted values first

    n_states = len(children)
    cp_complete = np.asarray(pending, dtype=np.int32) == 0

    # --- BFS failure links (buildFallbackMap, Automaton.hs:336-362) ---
    fail = np.zeros(n_states, dtype=np.int32)
    bfs_order: List[int] = []
    dq: deque = deque()
    for b in sorted(children[0]):
        c = children[0][b]
        fail[c] = 0
        dq.append(c)
    while dq:
        s = dq.popleft()
        bfs_order.append(s)
        for b in sorted(children[s]):
            c = children[s][b]
            # walk failure chain of s for a state with a transition on b
            f = fail[s]
            while b not in children[f] and f != 0:
                f = fail[f]
            nxt = children[f].get(b, 0)
            # avoid self-loop when s is a depth-1 state and b loops to c itself
            fail[c] = nxt if nxt != c else 0
            dq.append(c)

    # --- Flatten output sets (buildValueMap, Automaton.hs:367-380) ---
    out_lists: List[List[int]] = [list(own[0])]
    out_lists.extend([] for _ in range(n_states - 1))
    for s in bfs_order:
        out_lists[s] = own[s] + out_lists[fail[s]]

    # Pack CSR.  The root never emits, and mid-code-point states drop the
    # root-inherited (empty-needle) values: the reference's code-point
    # automaton emits the piggybacked empty-needle value once per code
    # point, not per byte.  Everything else at a mid-cp state DOES emit —
    # needles that are not whole UTF-8 sequences end at mid-cp states and
    # must still fire (byte-granular matching; with whole-sequence needles
    # a mid-cp state can only ever inherit root values anyway: a valid
    # needle being a suffix of a path would complete the path's trailing
    # code point, contradicting its mid-cp pending count).
    root_own = set(own[0])
    packed: List[List[int]] = []
    for s in range(n_states):
        if s == 0:
            packed.append([])
        elif not cp_complete[s]:
            packed.append([v for v in out_lists[s] if v not in root_own])
        else:
            packed.append(out_lists[s])
    counts = np.asarray([len(p) for p in packed], dtype=np.int32)
    out_offset = np.zeros(n_states + 1, dtype=np.int32)
    np.cumsum(counts, out=out_offset[1:])
    out_values = (
        np.concatenate([np.asarray(p, dtype=np.int32) for p in packed if p])
        if out_offset[-1] > 0
        else np.zeros(0, dtype=np.int32)
    )

    # --- Dense DFA-ization, vectorized by BFS depth level ---
    edge_src_l: List[int] = []
    edge_byte_l: List[int] = []
    edge_dst_l: List[int] = []
    for s, ch in enumerate(children):
        for b, t in ch.items():
            edge_src_l.append(s)
            edge_byte_l.append(b)
            edge_dst_l.append(t)
    edge_src = np.asarray(edge_src_l, dtype=np.int32)
    edge_byte = np.asarray(edge_byte_l, dtype=np.int32)
    edge_dst = np.asarray(edge_dst_l, dtype=np.int32)

    depth_arr = np.asarray(depth, dtype=np.int32)
    delta = np.zeros((n_states, 256), dtype=np.int32)
    root_mask = edge_src == 0
    delta[0, edge_byte[root_mask]] = edge_dst[root_mask]
    if n_states > 1:
        max_depth = int(depth_arr.max())
        edge_depth = depth_arr[edge_src]
        for d in range(1, max_depth + 1):
            states_d = np.flatnonzero(depth_arr == d)
            delta[states_d] = delta[fail[states_d]]
            em = edge_depth == d
            delta[edge_src[em], edge_byte[em]] = edge_dst[em]

    return AcMachine(
        delta=delta,
        out_offset=out_offset,
        out_values=out_values,
        match_count=counts,
        values=values,
        needles=needles,
        max_needle_bytes=max((len(n) for n in needles), default=0),
        edge_src=edge_src,
        edge_byte=edge_byte,
        edge_dst=edge_dst,
        fail=fail,
        cp_complete=cp_complete,
    )


# ---------------------------------------------------------------------------
# Scalar fold API (the oracle; mirrors runWithCase, Automaton.hs:442-534)
# ---------------------------------------------------------------------------


def run_with_case(
    case: CaseSensitivity,
    seed: Any,
    f: Callable[[Any, Match], Any],
    machine: AcMachine,
    text: utf8.TextLike,
) -> Any:
    """Fold ``f`` over matches in order; ``f`` returns ``Step(acc)`` to
    continue or ``Done(acc)`` to early-exit (``Automaton.hs:442-534``).

    IgnoreCase lowers each haystack code point on the fly; match positions are
    always raw byte offsets one past the match end.
    """
    data = utf8.to_bytes(text)
    delta = machine.delta
    out_offset = machine.out_offset
    out_values = machine.out_values
    values = machine.values
    state = 0
    offset = 0
    n = len(data)
    if case is IGNORE_CASE:
        # Strict streaming lowering (utf8.decode_strict): valid minimal
        # sequences lower per code point, everything else passes through
        # byte-for-byte — identical to every other IgnoreCase
        # implementation (transducers, composed case-folding DFA).  Match
        # positions are raw byte offsets one past the unit containing the
        # match end (the reference's code-unit-granular matchPos,
        # Automaton.hs:99-102).
        while offset < n:
            n_units, cp, valid = utf8.decode_strict(data, offset)
            offset += n_units
            emit = utf8.unicode2utf8(int(utf8.LOWER_TABLE[cp])) if valid else (cp,)
            for b in emit:
                state = delta[state, b]
                lo, hi = out_offset[state], out_offset[state + 1]
                for k in range(lo, hi):
                    nxt = f(seed, Match(offset, values[out_values[k]]))
                    if isinstance(nxt, Done):
                        return nxt.acc
                    seed = nxt.acc if isinstance(nxt, Step) else nxt
        return seed
    # CaseSensitive: plain per-byte fold — the alphabet of this build is
    # bytes, so matches are collected after every byte (the reference
    # collects per code point, Automaton.hs:468-534; identical on needles
    # that are whole-code-point strings, and byte-granular — matching the
    # vectorized engines — on arbitrary byte needles).
    while offset < n:
        state = delta[state, data[offset]]
        offset += 1
        lo, hi = out_offset[state], out_offset[state + 1]
        for k in range(lo, hi):
            nxt = f(seed, Match(offset, values[out_values[k]]))
            if isinstance(nxt, Done):
                return nxt.acc
            seed = nxt.acc if isinstance(nxt, Step) else nxt
    return seed


def run_text(seed: Any, f: Callable[[Any, Match], Any], machine: AcMachine, text: utf8.TextLike) -> Any:
    """Case-sensitive fold (``runText``, ``Automaton.hs:539-541``)."""
    return run_with_case(CASE_SENSITIVE, seed, f, machine, text)


def run_lower(seed: Any, f: Callable[[Any, Match], Any], machine: AcMachine, text: utf8.TextLike) -> Any:
    """Fold over the on-the-fly lowercased text (``runLower``,
    ``Automaton.hs:551-553``). Needles must already be lowercase."""
    return run_with_case(IGNORE_CASE, seed, f, machine, text)


def all_matches(machine: AcMachine, text: utf8.TextLike, case: CaseSensitivity = CASE_SENSITIVE) -> List[Match]:
    """Collect every match in order (overlaps included)."""
    out: List[Match] = []

    def f(acc, m):
        acc.append(m)
        return Step(acc)

    return run_with_case(case, out, f, machine, text)


def count_matches(machine: AcMachine, text: utf8.TextLike, case: CaseSensitivity = CASE_SENSITIVE) -> int:
    """Count every match (the benchmark metric)."""

    class Box:
        n = 0

    def f(acc, _m):
        acc.n += 1
        return Step(acc)

    return run_with_case(case, Box(), f, machine, text).n


def needle_casings(needle: str) -> List[str]:
    """All strings that lowercase (per code point) to the given lowercase
    needle (``Automaton.hs:562-566``); empty if the needle is not lowercase.

        needle_casings("abc") == ["abc","abC","aBc","aBC","Abc","AbC","ABc","ABC"]
        needle_casings("ABC") == []
    """
    results = [""]
    for c in needle:
        options = utf8.unlower_code_point(c)
        results = [prefix + o for prefix in results for o in options]
        if not results:
            return []
    return results


__all__ = [
    "AcMachine",
    "Done",
    "Match",
    "Step",
    "all_matches",
    "build",
    "count_matches",
    "load_npz",
    "needle_casings",
    "presence_of_states",
    "run_lower",
    "run_text",
    "run_with_case",
    "save_npz",
    "validate_machine",
]
