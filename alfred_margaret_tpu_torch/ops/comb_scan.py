"""The port's engine dispatcher: bitap when the needles fit, else dense.

Counterpart of ``alfred_margaret_tpu/ops/comb_scan.py:make_pallas_engine``
and ``plan_bitap_auto``.  The JAX dispatcher weighs bitap against the dense,
comb and comb16 engines with a word budget measured on the TPU
(``bitap_word_budget``, at least 2 words).  This port has bitap and dense
only, and takes bitap up to that floor of 2 words, so every needle set the
port sends to bitap, the JAX package sends to bitap too.  A set that the JAX
package sends to comb or comb16 runs here on the dense engine, with the same
counts; the mid-tier engines and the budget re-derived on the H100 are
ROADMAP Queue A items 7 and 12.
"""

from __future__ import annotations

import os

from alfred_margaret_tpu.models.ac import AcMachine

from .bitap_scan import BitapAcEngine, plan_bitap
from .pallas_scan import CapacityError, DenseAcEngine

#: Registers per stream the dispatcher gives bitap: the floor of the JAX
#: package's ``bitap_word_budget``.
BITAP_MAX_WORDS = 2


def make_engine(machine: AcMachine, device):
    """``BitapAcEngine`` when ``plan_bitap`` fits ``BITAP_MAX_WORDS`` words
    (``AMT_BITAP=0`` disables it), else ``DenseAcEngine``; raises
    ``CapacityError`` when the dense table does not fit either."""
    lay = None
    if os.environ.get("AMT_BITAP") != "0":
        lay = plan_bitap(machine, max_words=BITAP_MAX_WORDS)
    if lay is not None:
        return BitapAcEngine(machine, layout=lay, device=device)
    try:
        return DenseAcEngine(machine, device=device)
    except CapacityError as e:
        raise CapacityError(
            f"{e}; larger automata need the mid-tier engines "
            "(comb16, grouped: ROADMAP Queue A item 12)"
        ) from e


__all__ = ["BITAP_MAX_WORDS", "make_engine"]
