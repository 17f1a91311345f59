"""Per-position states of the PyTorch port against the JAX package.

* Kernels: B5 (the dense packed entry at every step) and B12 (the comb16
  entry at every step of the full machine's tables), run here by their plain
  torch versions, equal the JAX kernels in interpret mode (``_states_call``)
  on the same stream plan: B5 on a bitap machine, a packing-2 machine, a NUL
  machine that is not zero-inert and ``t_tile=24, unroll=3``; B12 on one
  machine (its compile in interpret mode takes some 20 s), through the JAX
  engine's own full tables (``convert.comb16_full_tables_from_jax``).
* ``final_states`` of the dense, bitap, comb16 and comb32 engines equals the
  JAX engines' (which reuse the compiled states kernels) and both host C++
  engines'.
* Extraction through the packed states (no host corpus, or ``t_tile % 32 !=
  0``) equals the bitmap route, the JAX compaction (``_get_extract_fn``) of
  the JAX kernel's entries and the scalar oracle; the comb16 count bit of
  the full set is the minimized set's; the grouped engine without its host
  corpus (comb32 groups through B17, the comb16 group through B12) equals
  the grouped engine with it.

Tolerance: exact equality of every entry, state, position and value id.
"""

import dataclasses

import numpy as np
import pytest
import torch

from alfred_margaret_tpu.bench.dataformat import synth_corpus
from alfred_margaret_tpu.models import ac as jac
from alfred_margaret_tpu.native.cpp_engine import CppAcEngine as JaxCppAcEngine
from alfred_margaret_tpu.ops import bitap_scan as jbitap
from alfred_margaret_tpu.ops import comb16_scan as j16
from alfred_margaret_tpu.ops import comb_scan as jcomb
from alfred_margaret_tpu.ops.pallas_scan import PallasAcEngine

from alfred_margaret_tpu_torch import convert
from alfred_margaret_tpu_torch.kernels import comb16_states, dense_states
from alfred_margaret_tpu_torch.kernels.comb16 import comb16_states_plain
from alfred_margaret_tpu_torch.kernels.dense_count import dense_states_plain
from alfred_margaret_tpu_torch.models import ac
from alfred_margaret_tpu_torch.native.cpp_engine import CppAcEngine
from alfred_margaret_tpu_torch.ops import comb16_scan as t16
from alfred_margaret_tpu_torch.ops import comb_scan as tcomb
from alfred_margaret_tpu_torch.ops import pallas_scan as tpallas
from alfred_margaret_tpu_torch.ops.bitap_scan import BitapAcEngine
from alfred_margaret_tpu_torch.ops.grouped import GroupedAcEngine
from alfred_margaret_tpu_torch.ops.pallas_scan import DenseAcEngine, _zero_inert

from test_torch_comb16 import CONFIG2, NESTED, N200
from test_torch_grouped import MID, MID_HAY
from _torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

CPU = torch.device("cpu")
NEEDLES3 = ["tshirt", "shirts", "shorts"]
PACK30 = [bytes([97 + i % 11, 98 + (i * 3) % 9, 99 + i % 7]).decode() for i in range(30)]
NUL = ["a\x00b", "\x00\x00", "xyz"]


def _machines(needles):
    pairs = [(n, i) for i, n in enumerate(needles)]
    return jac.build(pairs), ac.build(pairs)


def _corpus(needles, n, seed):
    return synth_corpus([x for x in needles if "\x00" not in x] or needles, n,
                        hit_fraction=0.05, seed=seed) + "".join(needles[-2:]).encode() * 3


def _host_states(jm, tm, data):
    """Both host C++ engines' ``final_states``, which must agree."""
    want = JaxCppAcEngine(jm).final_states(data)
    np.testing.assert_array_equal(CppAcEngine(tm).final_states(data), want)
    return want


def _jax_extract(jeng, packed, st):
    """(positions ascending, states) of the JAX compaction of the JAX
    kernel's entries ``packed``, at full capacity (no count kernel)."""
    T, S = st.plan.time_len, jeng.S
    pos, pk, n = jeng._get_extract_fn(T, T * S)(
        packed, np.asarray(st.warm_np).reshape(-1), st.vend_t.reshape(-1), st.plan.emit_len)
    n = int(n)
    pos = np.asarray(pos[:n], dtype=np.int64)
    states = jeng._pk_states(np.asarray(pk[:n])).astype(np.int64)
    order = np.argsort(pos, kind="stable")
    return pos[order], states[order]


def _assert_same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == np.int64
        np.testing.assert_array_equal(g, w)


B5_CASES = [
    ("bitap", NEEDLES3, dict(t_tile=32)),
    ("packing2", PACK30, dict(t_tile=32)),
    ("nul", NUL, dict(t_tile=32)),
    ("t_tile24_unroll3", NEEDLES3 + ["hirt", "orts"], dict(t_tile=24, unroll=3)),
]


@pytest.mark.parametrize("name,needles,kw", B5_CASES, ids=[c[0] for c in B5_CASES])
def test_b5_matches_jax_kernel(name, needles, kw):
    jm, tm = _machines(needles)
    hay = _corpus(needles, 3 << 10, seed=len(needles))
    data = np.frombuffer(hay, np.uint8)
    jkw = dict(n_streams=128, interpret=True, **kw)
    if name == "bitap":
        jeng = jcomb.make_pallas_engine(jm, **jkw)
        assert isinstance(jeng, jbitap.BitapAcEngine)
        eng = BitapAcEngine(tm, device=CPU, n_streams=128, t_tile=kw["t_tile"])
    else:
        jeng = PallasAcEngine(jm, **jkw)
        eng = DenseAcEngine(tm, device=CPU, n_streams=128, t_tile=kw["t_tile"])
    st, pst = jeng.stage(data), eng.stage(data)
    T = st.plan.time_len
    assert pst.plan.time_len == T
    packed = jeng._states_call(st)
    want = np.asarray(packed).reshape(T, -1)
    got = dense_states(*eng.states_args(pst))
    assert got.dtype == torch.int32 and got.shape == (T, 128)
    np.testing.assert_array_equal(got.numpy(), want)
    assert eng.count_shift == jeng._count_shift

    # final_states: the JAX engine's (the same compiled kernel) and the hosts'.
    host = _host_states(jm, tm, data)
    np.testing.assert_array_equal(jeng.final_states_staged(st), host)
    fs = eng.final_states_staged(pst)
    assert fs.dtype == np.int32
    np.testing.assert_array_equal(fs, host)

    # Extraction through the packed states: no host corpus, or t_tile % 32.
    want_pos = _jax_extract(jeng, packed, st)
    _assert_same(eng.match_positions_staged(dataclasses.replace(pst, data_np=None)), want_pos)
    # With its host corpus: the bitmap route, or the packed one where t_tile % 32.
    _assert_same(eng.match_positions_staged(pst), want_pos)
    ends, vids = eng.matches_arrays_staged(dataclasses.replace(pst, data_np=None))
    assert [(int(e), int(v)) for e, v in zip(ends, vids)] == [
        (x.pos, x.value) for x in jac.all_matches(jm, hay)]
    if name == "packing2":
        assert eng.comp.packing == 2
    if name == "nul":
        assert not _zero_inert(tm)


def test_b12_matches_jax_kernel():
    # One machine: the JAX comb16 states kernel takes some 20 s to compile in
    # interpret mode.  NESTED has 4 count ranges and a count-minimized table
    # set apart from the full one.
    jm, tm = _machines(NESTED)
    hay = _corpus(NESTED, 3 << 10, seed=2)
    data = np.frombuffer(hay, np.uint8)
    kw = dict(n_streams=128, t_tile=32)
    jeng = j16.Comb16PallasAcEngine(jm, interpret=True, **kw)
    eng = t16.Comb16AcEngine(tm, device=CPU, **kw)
    assert eng.c16 is not eng.c16_full and eng.full_tables is not eng.tables
    st, pst = jeng.stage(data), eng.stage(data)
    T = st.plan.time_len
    packed = jeng._states_call(st)
    want = np.asarray(packed).reshape(T, -1)
    got = comb16_states(*eng.states_args(pst))
    assert got.dtype == torch.int32 and got.shape == (T, 128)
    np.testing.assert_array_equal(got.numpy(), want)
    full_t = convert.comb16_full_tables_from_jax(jeng, CPU)
    for f, v in full_t.__dict__.items():
        w = getattr(eng.full_tables, f)
        assert torch.equal(w, v) if torch.is_tensor(v) else w == v, f
    args = (pst.streams, full_t.classmap, full_t.comb, full_t.aux, full_t.root_row,
            full_t.segtable, full_t.BB, full_t.owner_mask, full_t.CB, full_t.root_cb)
    assert torch.equal(comb16_states(*args), got)

    host = _host_states(jm, tm, data)
    np.testing.assert_array_equal(jeng.final_states_staged(st), host)
    np.testing.assert_array_equal(eng.final_states_staged(pst), host)
    want_pos = _jax_extract(jeng, packed, st)
    _assert_same(eng.match_positions_staged(dataclasses.replace(pst, data_np=None)), want_pos)
    _assert_same(eng.match_positions_staged(pst), want_pos)  # the bitmap route (B13)


@pytest.mark.parametrize("needles", [NESTED, CONFIG2, N200[:120]], ids=["nested", "config2", "n120"])
def test_comb16_count_bit_is_the_minimized_sets(needles):
    # The JAX engine masks the full set's entries with the minimized set's
    # count shift; the port with the full set's.  They are the same.
    _, tm = _machines(needles)
    eng = t16.Comb16AcEngine(tm, device=CPU, n_streams=128, t_tile=32)
    assert eng.count_shift == eng.c16_full.count_shift == eng.c16.count_shift
    assert eng.c16_full.CB == eng.c16.CB == 1


def test_comb32_final_states_match_jax_and_hosts():
    jm, tm = _machines(N200)
    data = np.frombuffer(_corpus(N200, 3 << 10, seed=5), np.uint8)
    kw = dict(n_streams=128, t_tile=32)
    jeng = jcomb.CombPallasAcEngine(jm, interpret=True, **kw)
    eng = tcomb.CombAcEngine(tm, device=CPU, **kw)
    host = _host_states(jm, tm, data)
    np.testing.assert_array_equal(jeng.final_states(data), host)
    np.testing.assert_array_equal(eng.final_states(data), host)
    assert eng.final_states(b"").shape == (0,)


@pytest.mark.parametrize("kind", ["dense", "bitap", "comb16", "comb32"])
def test_final_states_match_hosts_on_wider_corpora(kind):
    needles = {"dense": PACK30, "bitap": NEEDLES3, "comb16": CONFIG2, "comb32": N200}[kind]
    engine = {"dense": DenseAcEngine, "bitap": BitapAcEngine, "comb16": t16.Comb16AcEngine,
              "comb32": tcomb.CombAcEngine}[kind]
    jm, tm = _machines(needles)
    data = np.frombuffer(_corpus(needles, 24 << 10, seed=6), np.uint8)
    eng = engine(tm, device=CPU, n_streams=512, t_tile=64)
    np.testing.assert_array_equal(eng.final_states(data), _host_states(jm, tm, data))
    st = eng.stage(data)
    _assert_same(eng.match_positions_packed(st), eng.match_positions_staged(st))


def test_packed_extraction_skips_the_states_kernel_without_matches(monkeypatch):
    calls = []
    monkeypatch.setattr(tpallas, "dense_states",
                        lambda *a: calls.append(1) or dense_states_plain(*a))
    monkeypatch.setattr(t16, "comb16_states",
                        lambda *a: calls.append(1) or comb16_states_plain(*a))
    miss = np.frombuffer(b"0123456789 " * 300, np.uint8)
    for eng in (DenseAcEngine(ac.build([(n, 0) for n in PACK30]), device=CPU, n_streams=128),
                t16.Comb16AcEngine(ac.build([(n, 0) for n in CONFIG2]), device=CPU,
                                   n_streams=128)):
        st = dataclasses.replace(eng.stage(miss), data_np=None)
        pos, states = eng.match_positions_staged(st)
        assert len(pos) == len(states) == 0 and calls == []
    assert len(eng.final_states(miss)) == len(miss) and calls == [1]


def test_grouped_extraction_without_host_corpus():
    # mid(150) at max_rows=4: four comb32 groups (B15 + B17) and one comb16
    # group (B8 + B12 without the host corpus, B13 with it).
    _, tm = _machines(MID)
    eng = GroupedAcEngine(tm, device=CPU, max_rows=4, n_streams=256, t_tile=64)
    kinds = sorted(type(e).__name__ for e in eng.engines)
    assert kinds == ["Comb16AcEngine"] + ["CombAcEngine"] * 4
    data = np.frombuffer(MID_HAY, np.uint8)
    st = eng.stage(data)
    bare = dataclasses.replace(st, data_np=None)
    ends, vids = eng.matches_arrays_staged(st)
    got_ends, got_vids = eng.matches_arrays_staged(bare)
    np.testing.assert_array_equal(got_ends, ends)
    np.testing.assert_array_equal(got_vids, vids)
    assert [(int(e), int(v)) for e, v in zip(ends, vids)] == [
        (x.pos, x.value) for x in ac.all_matches(tm, MID_HAY)]
    np.testing.assert_array_equal(eng.value_presence_staged(bare, len(MID)),
                                  eng.value_presence_staged(st, len(MID)))
    c16 = next(e for e in eng.engines if type(e) is t16.Comb16AcEngine)
    _assert_same(c16.match_positions_staged(bare), c16.match_positions_staged(st))
