"""Turn the JAX engines' kernel tables into the port's tensors.

The JAX engines keep their tables in the TPU's 128-lane rows:
``PallasAcEngine`` a ``[2, 128]`` class map and a ``[rows, 128]`` packed
table (for counting, for the hit bitmap's dense step, and, from
``_sticky_setup()``, for the sticky scan), ``BitapAcEngine`` a ``[2V, 128]``
mask table (for counting, containsAny, presence and the hit bitmap's bitap
step).  These functions take those arrays as numpy (``np.asarray`` of the
JAX arrays) and return the tables the port's kernels read, so a test can
feed the JAX kernel and the port the very same tables.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.bitap_scan import BitapLayout, BitapTables
from .ops.pallas_scan import _STATE_BITS, _STATE_BITS16, DenseTables, StickyTables


def dense_tables_from_jax(classmap, table, n_states: int, k: int, packing: int, device) -> DenseTables:
    """``PallasAcEngine._classmap_dev`` ([2, 128]) and ``._table_dev``
    ([rows, 128]) as B1 tables."""
    classmap = np.asarray(classmap, dtype=np.int32).reshape(-1)
    table = np.asarray(table, dtype=np.int32).reshape(-1)
    if classmap.shape != (256,):
        raise ValueError("classmap must hold 256 entries")
    if packing not in (1, 2):
        raise ValueError(f"packing must be 1 or 2, got {packing}")
    if table.size * packing < n_states * k:
        raise ValueError(f"table of {table.size} words cannot hold {n_states}*{k} entries")
    return DenseTables(
        classmap=torch.from_numpy(classmap.copy()).to(device),
        table=torch.from_numpy(table.copy()).to(device),
        packing=packing,
        state_bits=_STATE_BITS16 if packing == 2 else _STATE_BITS,
    )


def sticky_tables_from_jax(cm, tab, n_states: int, k: int, packing: int, absorb: int,
                           device) -> StickyTables:
    """``PallasAcEngine._sticky_setup()``'s ``["cm"]`` ([2, 128]) and
    ``["tab"]`` ([rows, 128]) as B3 tables; ``n_states``, ``k`` and
    ``packing`` are its ``["comp"]``'s and ``absorb`` its ``["absorb_pk"]``."""
    t = dense_tables_from_jax(cm, tab, n_states, k, packing, device)
    if not 0 <= absorb < n_states * k:
        raise ValueError(f"absorb entry {absorb} outside the {n_states}*{k} table")
    return StickyTables(t.classmap, t.table, t.packing, t.state_bits, int(absorb))


def bitap_tables_from_jax(btab, layout: BitapLayout, device) -> BitapTables:
    """``BitapAcEngine._btab_dev`` ([2V, 128]) as B2 tables for ``layout``
    (the layout supplies seeds and count fields)."""
    btab = np.asarray(btab, dtype=np.int32)
    V = layout.n_words
    if btab.shape != (2 * V, 128):
        raise ValueError(f"btab must be [{2 * V}, 128] for {V} words, got {btab.shape}")
    return BitapTables.from_layout(layout, device, btab=btab.reshape(V, 256))


__all__ = ["bitap_tables_from_jax", "dense_tables_from_jax", "sticky_tables_from_jax"]
