"""Independent Aho-Corasick conformance oracle (runtime failure-link NFA).

A copy of ``alfred_margaret_tpu/models/nfa_oracle.py``.  Every other engine
of the port executes tables produced by one construction (``models.ac.build``:
trie -> BFS failure links -> dense DFA-ization with flattened outputs): the
host C++ engine, the reference scan engine and the CUDA kernels all run the
same arrays, so a construction bug would pass every parity gate between them.
The reference project guards against this with cross-IMPLEMENTATION count
checks against other Aho-Corasick libraries; this module is the in-tree
independent implementation: a textbook Aho-Corasick NFA that shares NO code
or arrays with ``models.ac`` -

* its own byte trie (dicts, not IntMaps or numpy),
* its own failure-link BFS,
* **runtime** failure-link transitions (goto miss => follow fail links until
  a goto exists or root; no DFA-ization), and
* **runtime** output collection by walking the suffix-link chain at every
  node (no flattened output sets).

Emission semantics mirror the reference contract
(``src/Data/Text/AhoCorasick/Automaton.hs:367-380``): at each end position,
the entered node's own needles first (longest), then suffix-chain needles in
decreasing length; duplicate needles emit the later-inserted payload first
(``Automaton.hs:259-263``: ``insertWith (++)`` prepends); empty needles
piggyback on every non-root, code-point-complete state (see ``__init__``).

It is scalar Python (~1-3 MB/s on a host core): use it on slices, as the
JAX package's ``bench/configs.py`` does for its conformance gates.
"""

from __future__ import annotations

from collections import deque
from typing import Iterable, List, Sequence, Tuple

from ..utils import utf8


class NfaOracle:
    """Textbook Aho-Corasick NFA over bytes with runtime failure links."""

    def __init__(self, needles: Iterable[utf8.TextLike]):
        needles = [utf8.to_bytes(n) for n in needles]
        self.needles = needles
        # Trie: per node a dict byte -> node id; outputs = needle ids ending
        # exactly at this node (insertion order => payload merge order).
        self._goto: List[dict] = [{}]
        self._out: List[List[int]] = [[]]
        # Pending continuation bytes at each node (0 <=> the node's path
        # ends at a code point boundary).  Mid-code-point nodes suppress the
        # root-inherited empty-needle values — the reference's code-point
        # automaton emits the piggybacked value once per code point, not
        # per byte (same rule as ``models/ac.py`` build).
        self._pending: List[int] = [0]
        for vid, needle in enumerate(needles):
            if len(needle) == 0:
                # Empty needle: the reference stores its value at the ROOT
                # and never collects at the root itself, but buildValueMap's
                # flattening leaks it into every other state's output set
                # via the failure chain (``Automaton.hs:367-380``) — so the
                # empty needle matches at every consumed code point whose
                # resulting state is non-root.  models/ac.py reproduces
                # this bit-exactly; the oracle must agree (its round-2
                # version silently dropped empty needles and raised FALSE
                # conformance violations on any needle set containing "").
                self._out[0].insert(0, vid)
                continue
            node = 0
            for b in needle:
                nxt = self._goto[node].get(b)
                if nxt is None:
                    nxt = len(self._goto)
                    self._goto[node][b] = nxt
                    self._goto.append({})
                    self._out.append([])
                    self._pending.append(
                        utf8._LEAD_LEN[b] - 1
                        if self._pending[node] == 0
                        else self._pending[node] - 1
                    )
                node = nxt
            # Duplicate needles: later-inserted payload FIRST — the
            # reference's ``insertWith (++)`` prepends (``Automaton.hs:
            # 259-263``).
            self._out[node].insert(0, vid)
        # Failure links: classic BFS (child fail = follow parent's fail
        # chain until a goto on the edge byte exists, else root).
        self._fail = [0] * len(self._goto)
        q = deque()
        for b, child in self._goto[0].items():
            q.append(child)
        while q:
            node = q.popleft()
            for b, child in self._goto[node].items():
                f = self._fail[node]
                while f and b not in self._goto[f]:
                    f = self._fail[f]
                self._fail[child] = self._goto[f].get(b, 0)
                if self._fail[child] == child:  # depth-1 nodes fail to root
                    self._fail[child] = 0
                q.append(child)

    def _step(self, node: int, b: int) -> int:
        """Runtime NFA transition: goto else follow failure links."""
        while True:
            nxt = self._goto[node].get(b)
            if nxt is not None:
                return nxt
            if node == 0:
                return 0
            node = self._fail[node]

    def _emit(self, node: int) -> List[int]:
        """Runtime output collection along the suffix-link chain, ending at
        the root's (empty-needle) values — emitted only at non-root,
        non-mid-code-point nodes, matching the flattened-set semantics the
        byte-level engines reproduce (``models/ac.py`` module docstring)."""
        out: List[int] = []
        n = node
        while n:
            out.extend(self._out[n])
            n = self._fail[n]
        if node and self._out[0] and self._pending[node] == 0:
            out.extend(self._out[0])
        return out

    def count(self, haystack: utf8.TextLike) -> int:
        data = utf8.to_bytes(haystack)
        node, total = 0, 0
        n_empty = len(self._out[0])
        for b in data:
            node = self._step(node, b)
            n = node
            while n:
                total += len(self._out[n])
                n = self._fail[n]
            if node and n_empty and self._pending[node] == 0:
                total += n_empty
        return total

    def all_matches(self, haystack: utf8.TextLike) -> List[Tuple[int, int]]:
        """[(end position one past the match, needle id)] in reference
        emission order."""
        data = utf8.to_bytes(haystack)
        node = 0
        out: List[Tuple[int, int]] = []
        for i, b in enumerate(data):
            node = self._step(node, b)
            for vid in self._emit(node):
                out.append((i + 1, vid))
        return out

    def contains_any(self, haystack: utf8.TextLike) -> bool:
        data = utf8.to_bytes(haystack)
        node = 0
        n_empty = len(self._out[0])
        for b in data:
            node = self._step(node, b)
            if node and n_empty and self._pending[node] == 0:
                return True
            n = node
            while n:
                if self._out[n]:
                    return True
                n = self._fail[n]
        return False


def cross_check_counts(
    needles: Sequence[utf8.TextLike], haystack: utf8.TextLike, observed: int
) -> None:
    """Assert the independent NFA count equals an engine's count (the
    reference benchmark's counts-on-stderr conformance protocol, applied
    in-process)."""
    want = NfaOracle(needles).count(haystack)
    if want != observed:
        raise AssertionError(
            f"conformance violation: independent NFA counts {want}, engine "
            f"reported {observed}"
        )


def cross_check_matches(
    needles: Sequence[utf8.TextLike],
    haystack: utf8.TextLike,
    ends,
    value_ids,
) -> None:
    """Assert an engine's full (end, needle id) match list equals the
    independent NFA's, *including emission order* (end ascending; same-end
    in state-output order).  Strictly stronger than ``cross_check_counts``
    — a construction bug that miscounts per-state outputs but preserves totals
    (or swaps needle identities) is caught here."""
    want = NfaOracle(needles).all_matches(haystack)
    got = [(int(e), int(v)) for e, v in zip(ends, value_ids)]
    if want != got:
        n = len(want)
        first_bad = next(
            (i for i in range(max(n, len(got)))
             if i >= n or i >= len(got) or want[i] != got[i]),
            None,
        )
        raise AssertionError(
            f"conformance violation: independent NFA emits {n} matches, "
            f"engine reported {len(got)}; first divergence at index "
            f"{first_bad}: want {want[first_bad] if first_bad is not None and first_bad < n else '<none>'}, "
            f"got {got[first_bad] if first_bad is not None and first_bad < len(got) else '<none>'}"
        )


__all__ = ["NfaOracle", "cross_check_counts", "cross_check_matches"]
