"""The port's engine dispatcher, and the comb builders' shared helpers.

Counterpart of ``alfred_margaret_tpu/ops/comb_scan.py``: ``_choose_classes``,
``_center_candidates`` and ``_mism_matrix`` are copied as numpy (that module
imports ``jax``; ``tests/test_torch_comb16.py`` pins the copies), and
``make_engine`` takes the place of ``make_pallas_engine`` and
``plan_bitap_auto``.

The JAX dispatcher ranks its engines by the TPU's table gathers per byte
(``plan_pallas``) and weighs bitap against them with a word budget measured
on the TPU (``bitap_word_budget``, at least 2 words).  Neither law holds on
the H100: the dense kernel does one shared-memory lookup per byte whatever
its row count, comb16 three or four dependent ones.  So the port takes bitap
up to that floor of 2 words (every set the port sends to bitap, the JAX
package sends to bitap too), then dense wherever its table fits, and only
then comb16.  Re-deriving the order from H100 numbers is ROADMAP Queue A
item 7; the grouped engine for sets that overflow comb16 is item 12.
"""

from __future__ import annotations

import os

import numpy as np

from ..models.ac import AcMachine
from .bitap_scan import BitapAcEngine, plan_bitap
from .pallas_scan import CapacityError, DenseAcEngine

#: Registers per stream the dispatcher gives bitap: the floor of the JAX
#: package's ``bitap_word_budget``.
BITAP_MAX_WORDS = 2


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


def make_engine(machine: AcMachine, device="cuda"):
    """``BitapAcEngine`` when ``plan_bitap`` fits ``BITAP_MAX_WORDS`` words
    (``AMT_BITAP=0`` disables it), else ``DenseAcEngine`` when its table
    fits, else ``Comb16AcEngine``; raises ``CapacityError`` naming the
    grouped engine when comb16 does not fit either."""
    from .comb16_scan import Comb16AcEngine  # comb16_scan imports this module's helpers

    lay = None
    if os.environ.get("AMT_BITAP") != "0":
        lay = plan_bitap(machine, max_words=BITAP_MAX_WORDS)
    if lay is not None:
        return BitapAcEngine(machine, layout=lay, device=device)
    try:
        return DenseAcEngine(machine, device=device)
    except CapacityError:
        pass
    try:
        return Comb16AcEngine(machine, device=device)
    except CapacityError as e:
        raise CapacityError(
            f"{e}; larger automata need the grouped engine: ROADMAP Queue A item 12"
        ) from e


__all__ = ["BITAP_MAX_WORDS", "make_engine"]
