"""Turn the JAX engines' kernel tables into the port's tensors.

The JAX engines keep their tables in the TPU's 128-lane rows:
``PallasAcEngine`` a ``[2, 128]`` class map and a ``[rows, 128]`` packed
table (for counting, for the hit bitmap's dense step, and, from
``_sticky_setup()``, for the sticky scan), ``BitapAcEngine`` a ``[2V, 128]``
mask table (for counting, containsAny, presence and the hit bitmap's bitap
step), ``Comb16PallasAcEngine`` a class map, comb and aux rows and a
``[2, 128]`` root row and segment table per table set (for counting and the
hit bitmap's comb16 step, from ``_sticky_setup()`` for the sticky scan,
and from ``_full_set()`` for the packed states), ``CombPallasAcEngine`` a class map, comb rows and default rows per
table set (count, sticky, and the full machine's for the packed states),
the stride-2 screen's ``[V, 128]`` pair table, and
``GroupedPallasAcEngine`` the stacked ``[G, ...]`` arrays of its fused count
and sticky table sets.  These functions take those arrays as numpy
(``np.asarray`` of the JAX arrays) and return the tables the port's kernels
read, so a test can feed the JAX kernel and the port the very same tables.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.bitap_scan import BitapLayout, BitapTables
from .ops.comb_scan import CombStickyTables, CombTables
from .ops.comb16_scan import Comb16GroupTables, Comb16StickyTables, Comb16Tables
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
    """``BitapAcEngine._btab_dev`` ([2 VT, 128], VT the layout's match words
    and trap register) as B2, B4 and B7 tables for ``layout`` (the layout
    supplies seeds, count fields and trap masks)."""
    btab = np.asarray(btab, dtype=np.int32)
    VT = len(layout.all_words())
    if btab.shape != (2 * VT, 128):
        raise ValueError(f"btab must be [{2 * VT}, 128] for {VT} words, got {btab.shape}")
    return BitapTables.from_layout(layout, device, btab=btab.reshape(VT, 256))


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


def comb16_full_tables_from_jax(engine, device) -> Comb16Tables:
    """The full machine's tables of a ``Comb16PallasAcEngine``, its
    ``_full_set()`` with ``_consts`` of that set, as B12 tables."""
    c16f, (_, _, cm, comb, aux, rootseg) = engine._full_set()
    return _c16_tables(cm, comb, aux, rootseg, engine._consts(c16f), c16f, device)


def _comb_tables(cm, comb, deft, cmach, device) -> CombTables:
    cm, comb, deft = (np.asarray(x, dtype=np.int32) for x in (cm, comb, deft))
    want = {"classmap": (cm, (2, 128)), "comb": (comb, (cmach.rows_c, 128)),
            "def_table": (deft, (cmach.rows_d, 128))}
    for name, (x, shape) in want.items():
        if x.shape != shape:
            raise ValueError(f"{name} must be {shape}, got {x.shape}")
    return CombTables.from_arrays(cm, comb, deft, cmach.k, cmach.owner_bits,
                                  int(cmach.base[0]), int(cmach.def_idx[0]), device)


def comb_tables_from_jax(engine, device):
    """``(count tables, sticky tables, full tables)`` of a
    ``CombPallasAcEngine``: its ``_classmap_dev``, ``_comb_dev`` and
    ``_def_dev`` with its ``comb`` as B15 tables, its ``_sticky_setup()`` as
    B16 tables, and its ``_full_set()`` as B17 tables."""
    count = _comb_tables(engine._classmap_dev, engine._comb_dev, engine._def_dev, engine.comb,
                         device)
    c = engine._sticky_setup()
    t = _comb_tables(c["cm"], c["comb_dev"], c["def_dev"], c["comb"], device)
    sticky = CombStickyTables(**t.__dict__, absorb=int(c["absorb_base"]))
    combf, (_, _, cm, comb, deft) = engine._full_set()
    return count, sticky, _comb_tables(cm, comb, deft, combf, device)


def comb16_group_tables_from_jax(stacked: dict, device, sticky: bool = False) -> Comb16GroupTables:
    """A ``GroupedPallasAcEngine`` fused table set, ``_fused["stacked"]``
    (count) or ``_fused_sticky["stacked"]`` (``sticky``): ``classmap``
    ``[G, 2, 128]``, ``comb`` ``[G, rows_c, 128]``, ``aux`` ``[G, rows_a,
    128]``, ``rootseg`` ``[G, 2, 128]``, ``gscal`` and ``consts``, as B9 or B11
    tables.  (The groups' builds are not in the dict, so the probe windows
    are not checked here; the port's own builds check them.)"""
    cst = stacked["consts"]
    G = np.asarray(stacked["classmap"]).shape[0]
    want = {"classmap": (G, 2, 128), "comb": (G, cst["rows_c"], 128),
            "aux": (G, cst["rows_a"], 128), "rootseg": (G, 2, 128)}
    for name, shape in want.items():
        if np.asarray(stacked[name]).shape != shape:
            raise ValueError(f"{name} must be {shape}, got {np.asarray(stacked[name]).shape}")
    return Comb16GroupTables.from_stacked(
        {k: (v if k == "consts" else np.asarray(v)) for k, v in stacked.items()}, device,
        sticky=sticky,
    )


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
    "comb_tables_from_jax",
    "comb16_full_tables_from_jax",
    "comb16_group_tables_from_jax",
    "comb16_tables_from_jax",
    "dense_tables_from_jax",
    "filter_tables_from_jax",
    "sticky_tables_from_jax",
]
