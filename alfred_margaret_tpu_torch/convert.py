"""Turn the JAX engines' kernel tables into the port's tensors.

The JAX engines keep their tables in the TPU's 128-lane rows:
``PallasAcEngine`` a ``[2, 128]`` class map and a ``[rows, 128]`` packed
table (for counting, for the hit bitmap's dense step, and, from
``_sticky_setup()``, for the sticky scan), ``BitapAcEngine`` a ``[2V, 128]``
mask table (for counting, containsAny, presence and the hit bitmap's bitap
step), ``Comb16PallasAcEngine`` a class map, comb and aux rows and a
``[2, 128]`` root row and segment table per table set (for counting and the
hit bitmap's comb16 step, and, from ``_sticky_setup()``, for the sticky
scan) and the stride-2 screen's ``[V, 128]`` pair table.  These functions take those arrays as numpy (``np.asarray`` of the
JAX arrays) and return the tables the port's kernels read, so a test can
feed the JAX kernel and the port the very same tables.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.bitap_scan import BitapLayout, BitapTables
from .ops.comb16_scan import Comb16StickyTables, Comb16Tables
from .ops.filter_scan import FilterTables
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


def _c16_tables(cm, comb, aux, rootseg, consts: dict, c16, device) -> Comb16Tables:
    rootseg = np.asarray(rootseg, dtype=np.int32)
    if rootseg.shape != (2, 128):
        raise ValueError(f"rootseg must be [2, 128], got {rootseg.shape}")
    return Comb16Tables.from_arrays(
        np.asarray(cm).reshape(-1), np.asarray(comb), np.asarray(aux), rootseg[0], rootseg[1],
        consts["count_ranges"], consts["BB"], int(consts["owner_mask"]).bit_length(),
        consts["CB"], consts["root_cb"], device, bases=c16.base, cbases=c16.cbase, k=c16.k,
    )


def comb16_tables_from_jax(engine, device):
    """``(count tables, sticky tables)`` of a ``Comb16PallasAcEngine``: its
    ``_tab`` with ``_consts(c16)`` as B8 and B13 tables, and its
    ``_sticky_setup()`` with the sticky build's ``_consts`` as B10 tables."""
    _, _, cm, comb, aux, rootseg = engine._tab
    count = _c16_tables(cm, comb, aux, rootseg, engine._consts(engine.c16), engine.c16, device)
    c = engine._sticky_setup()
    t = _c16_tables(c["cm"], c["comb_dev"], c["aux_dev"], c["rootseg_dev"],
                    engine._consts(c["c16"]), c["c16"], device)
    return count, Comb16StickyTables(**t.__dict__, absorb=int(c["absorb_cb"]))


def filter_tables_from_jax(engine, device) -> FilterTables:
    """The stride-2 screen of a JAX engine: ``_filter_btab`` ([V, 128], or
    one row of zeros when V = 0) with the seeds, end masks and short needles
    of ``_filter_lay``, as B14 tables."""
    lay = engine._filter_lay
    btab = np.asarray(engine._filter_btab, dtype=np.int32)
    V = lay.n_words
    if btab.shape != (max(V, 1), 128):
        raise ValueError(f"btab must be [{max(V, 1)}, 128] for {V} words, got {btab.shape}")
    return FilterTables.from_layout(lay, device, btab=btab[:V])


__all__ = [
    "bitap_tables_from_jax",
    "comb16_tables_from_jax",
    "dense_tables_from_jax",
    "filter_tables_from_jax",
    "sticky_tables_from_jax",
]
