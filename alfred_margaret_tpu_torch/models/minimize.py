"""Count-preserving DFA minimization for the count, contains and hit-bitmap
paths of the comb16 engine.

Those kernels never report which needle matched, only how many matches end at
each position (or whether any does).  Two states that emit the same match
count and have equivalent successors are interchangeable for them even when
their value sets differ, so count-preserving minimization (Moore partition
refinement) removes some 10-20% of the states of random needle sets.  Never
use a count-minimized machine where state identity or value ids escape the
kernel: match extraction replays the full machine.

The port's copy of ``alfred_margaret_tpu/models/minimize.py``
(``tests/test_torch_comb16.py`` pins it to the original on seeded machines).
The per-machine memo of ``count_minimized`` lives under its own attribute, so
the two packages never hand each other their quotients.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from .ac import AcMachine

__all__ = ["minimize_for_counts", "count_minimized", "minimize_sticky", "quotient"]


def quotient(
    delta: np.ndarray, sig: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Coarsest congruence of ``delta`` respecting per-state signature
    ``sig``: Moore partition refinement with dict row interning
    (``np.unique(axis=0)`` void-record sorting is ~100x slower).  Returns ``(newid, rep_of, n_blocks)`` with
    blocks renumbered by first occurrence, the start state's block first.
    """
    S = delta.shape[0]

    # Column (byte-class) compression: refinement cost drops from 256 to k
    # successor columns.
    colkeys: Dict[bytes, int] = {}
    for c in range(256):
        colkeys.setdefault(delta[:, c].tobytes(), c)
    rep_cols = np.fromiter(colkeys.values(), dtype=np.int64)
    cdelta = delta[:, rep_cols].astype(np.int64)

    _, block = np.unique(np.asarray(sig, dtype=np.int64), return_inverse=True)
    block = block.astype(np.int32)
    n_blocks = int(block.max()) + 1
    while True:
        # Exact row interning via a byte-key dict: one O(S) pass per round.
        key = np.ascontiguousarray(
            np.concatenate([block[:, None], block[cdelta]], axis=1), dtype=np.int32
        )
        row_ids: Dict[bytes, int] = {}
        newblock = np.empty(S, dtype=np.int32)
        for s in range(S):
            newblock[s] = row_ids.setdefault(key[s].tobytes(), len(row_ids))
        if len(row_ids) == n_blocks:
            break
        block, n_blocks = newblock, len(row_ids)

    # Renumber blocks by first occurrence with the root's block first, so
    # state 0 stays the start state.  ``block`` is dense [0, n_blocks) from
    # return_inverse, so np.unique yields arange + first-occurrence indices.
    _, first = np.unique(block, return_index=True)
    key = first.copy()
    key[block[0]] = -1  # root's block sorts first
    ordix = np.argsort(key, kind="stable")
    remap = np.empty(n_blocks, dtype=np.int32)
    remap[ordix] = np.arange(n_blocks, dtype=np.int32)
    newid = remap[block]
    rep_of = first[ordix].astype(np.int64)
    return newid, rep_of, n_blocks


def minimize_for_counts(
    machine: AcMachine, protect: Optional[np.ndarray] = None
) -> AcMachine:
    """Coarsest count-preserving quotient of ``machine``.

    ``protect`` (optional int array of per-state tags) is folded into the
    initial signature so specially-interpreted states (e.g. a sticky view's
    absorbing state, whose final-base identity IS the result) never merge
    with behaviorally similar but semantically distinct states.

    The returned machine preserves: per-position match counts on every
    input, ``max_needle_bytes`` (warm-up overlap), ``composed_ci``, and a
    representative failure link per block (heuristic input to comb center
    selection).  ``out_values`` hold the representative state's value ids —
    counts are exact, value identities are NOT meaningful.
    """
    delta = machine.delta
    S = delta.shape[0]
    mc = machine.match_count

    sig = mc.astype(np.int64)
    if protect is not None:
        p = np.asarray(protect, dtype=np.int64)
        sig = sig * (int(p.max()) + 2) + p
    newid, rep_of, n_blocks = quotient(delta, sig)

    if n_blocks == S:  # already minimal — keep the original arrays
        return machine

    delta_min = np.take(newid, np.take(delta, rep_of, axis=0)).astype(delta.dtype)
    # Representative states' CSR output slices, gathered vectorized (a
    # per-block Python loop here dominated 10k-needle minimization).
    off = np.asarray(machine.out_offset, dtype=np.int64)
    starts = off[rep_of]
    lens = off[rep_of + 1] - starts
    out_offset = np.zeros(n_blocks + 1, dtype=np.int32)
    out_offset[1:] = np.cumsum(lens)
    total = int(out_offset[-1])
    idx = np.repeat(starts - out_offset[:-1], lens) + np.arange(total, dtype=np.int64)
    out_values = np.asarray(machine.out_values, dtype=np.int32)[idx]

    fail = None
    if machine.fail is not None:
        fail = newid[machine.fail[rep_of]].astype(np.int32)

    return AcMachine(
        delta=delta_min,
        out_offset=out_offset,
        out_values=np.asarray(out_values, dtype=np.int32),
        match_count=np.diff(out_offset).astype(np.int32),
        values=machine.values,
        needles=machine.needles,
        max_needle_bytes=machine.max_needle_bytes,
        fail=fail,
        cp_complete=None,
        composed_ci=machine.composed_ci,
    )


def count_minimized(machine: AcMachine) -> AcMachine:
    """``minimize_for_counts`` with the ``AMT_MINIMIZE=0`` kill switch and a
    per-machine memo (plan_pallas + every engine of one machine share the
    quotient instead of recomputing it)."""
    import os

    if os.environ.get("AMT_MINIMIZE", "1") == "0":
        return machine
    cached = getattr(machine, "_torch_count_min_cache", None)
    if cached is None:
        cached = minimize_for_counts(machine)
        machine._torch_count_min_cache = cached
    return cached


class _MinStickyView:
    """Quotient of an absorbing-state existence view (duck-typed like
    ``ops.pallas_scan._StickyView``: delta / match_count / fail / absorb)."""

    def __init__(self, delta, fail, absorb):
        self.delta = delta
        self.match_count = np.zeros(delta.shape[0], dtype=np.int32)
        self.fail = fail
        self.absorb = absorb


def minimize_sticky(view):
    """Count-style minimization of a sticky (absorbing) view.

    The absorbing state is protected by its signature (it is the only state
    tagged 1), so the "final state == absorb" readout survives merging.
    Returns ``view`` unchanged when already minimal or when the kill switch
    is set.
    """
    import os

    if os.environ.get("AMT_MINIMIZE", "1") == "0":
        return view
    S = view.delta.shape[0]
    sig = np.zeros(S, dtype=np.int64)
    sig[view.absorb] = 1
    newid, rep_of, n_blocks = quotient(view.delta, sig)
    if n_blocks == S:
        return view
    delta_min = np.take(newid, np.take(view.delta, rep_of, axis=0)).astype(
        view.delta.dtype
    )
    fail = None
    if view.fail is not None:
        fail = newid[view.fail[rep_of]].astype(np.int32)
    return _MinStickyView(delta_min, fail, int(newid[view.absorb]))
